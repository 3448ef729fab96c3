"""The benchmark's image generators, one for each kind of input a traffic
mix names (its `"image"` key). Each takes (size, seed) and returns the
image and the offsets of the strings it planted ("marks"), which the
check samples around.

Frozen copies of the port's `corpus.py` generators as they stood when the
benchmark was written, so that no later change to the port changes the
work a cell measures: `dense` is `make_corpus`, `firmware` is
`stateful_corpus`, and `disk` is `sparse_corpus` with a seed added, which
picks the first message and moves each message within its 128 KiB slot.
With the seed None `disk` is `sparse_corpus` byte for byte.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

MESSAGES = [
    b"/lib64/ld-linux-x86-64.so.2\x00",
    "Configuration déjà chargée €uro.".encode("utf-8"),
    "Device path: \\EFI\\BOOT\\BOOTX64.EFI".encode("utf-16-le"),
    "Русский текст в дампе памяти".encode("utf-16-le"),
    b"GET /index.html HTTP/1.1\r\nHost: example.com\r\n",
]

# (Python codec, text) of the firmware strings, in the encodings vendors
# ship.
FIRMWARE_MESSAGES = [
    ("shift_jis", "ファームウェアの更新に失敗しました。再起動してください"),
    ("euc_kr", "펌웨어 업데이트에 실패했습니다 다시 시도하십시오"),
    ("gb18030", "固件更新失败，请重新启动设备\U00020000"),
    ("iso2022_jp", "設定を保存しました OK カタカナ"),
    ("utf-8", "Firmware update failed: ошибка €42, réessayez"),
]

SLOT = 128 * 1024  # one message a slot in a disk image


def dense(size: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A process memory dump or compressed payload: random bytes with the
    MESSAGES (ASCII, UTF-8, UTF-16LE) at 2048 places."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=size, dtype=np.uint8)
    step = max(size // 2048, 4096)
    marks = np.arange(0, max(size - 256, 0), step, dtype=np.int64)
    for off in marks.tolist():
        m = MESSAGES[(off // step) % len(MESSAGES)]
        data[off:off + len(m)] = np.frombuffer(m, np.uint8)
    return data, marks


def firmware(size: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A firmware image: sections of 256 KiB, in turn zeros (padding), a
    string table, 0xFF (erased flash), a string table, and once in 16
    sections random bytes (a compressed payload). A string table holds
    the FIRMWARE_MESSAGES in turn, one every 192 bytes between NULs;
    every fourth table is torn: it starts in the middle of a message."""
    sec = 256 * 1024
    rng = np.random.default_rng(seed)
    raw = np.zeros(size, np.uint8)
    msgs = [np.frombuffer(t.encode(c), np.uint8) for c, t in FIRMWARE_MESSAGES]
    marks = []
    k = 0
    for s, off in enumerate(range(0, size, sec)):
        end = min(off + sec, size)
        if s % 16 == 5:
            raw[off:end] = rng.integers(0, 256, end - off, dtype=np.uint8)
        elif s % 4 == 2:
            raw[off:end] = 0xFF
        elif s % 2 == 1:
            torn = (s // 2) % 4 == 3
            for o in range(off, end - 192, 192):
                m = msgs[k % len(msgs)]
                k += 1
                if torn and o == off:
                    m = m[len(m) // 2 + 1:]
                raw[o:o + len(m)] = m
                marks.append(o)
    return raw, np.asarray(marks, np.int64)


def disk(size: int, seed: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """A mostly empty disk image: zeros with one of the MESSAGES in each
    128 KiB slot; the first and last 4 KiB stay zero. Seed None places
    message k % 5 at 4096 + k * 128 KiB; a seed picks the first message
    and the offset of each within its slot."""
    raw = np.zeros(size, np.uint8)
    slots = np.arange(4096, max(size - 8192, 0), SLOT, dtype=np.int64)
    if seed is None:
        first, marks = 0, slots
    else:
        rng = np.random.default_rng(seed)
        first = int(rng.integers(len(MESSAGES)))
        room = SLOT - 4096 - max(len(m) for m in MESSAGES)
        marks = np.minimum(slots + rng.integers(0, room, len(slots)),
                           size - 4096 - 128)
    for k, off in enumerate(marks.tolist()):
        m = MESSAGES[(first + k) % len(MESSAGES)]
        raw[off:off + len(m)] = np.frombuffer(m, np.uint8)
    return raw, marks


KINDS = {"dense": dense, "firmware": firmware, "disk": disk}


def image_seed(seed: int, k: int) -> int:
    """The seed of image `k` of a run with seed `seed` (any whole
    number, negative or past 64 bits included)."""
    words = [seed & 0xFFFFFFFFFFFFFFFF, (seed >> 64) & 0xFFFFFFFF,
             int(seed < 0), k]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
