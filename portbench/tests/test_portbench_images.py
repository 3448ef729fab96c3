"""The image generators: deterministic per seed, and the port's corpus
functions where the copy keeps their bytes."""

import numpy as np
import pytest

from portbench import images
from stringsext_tpu_torch import corpus

SIZE = 3 << 20


@pytest.mark.parametrize("kind", sorted(images.KINDS))
def test_generator_is_deterministic_per_seed(kind):
    make = images.KINDS[kind]
    a, ma = make(SIZE, 2**33 + 17)
    b, mb = make(SIZE, 2**33 + 17)
    assert a.dtype == np.uint8 and len(a) == SIZE
    assert (a == b).all() and (ma == mb).all()
    c, _ = make(SIZE, 2**33 + 18)
    assert (a != c).any()


@pytest.mark.parametrize("kind,original", [
    ("dense", lambda n: corpus.make_corpus(n, 0)),
    ("firmware", lambda n: corpus.stateful_corpus(n, 0)),
])
def test_copy_keeps_seed_zero_bytes(kind, original):
    got, marks = images.KINDS[kind](SIZE, 0)
    assert (got == original(SIZE)).all()
    assert len(marks) and (marks < SIZE).all()


def test_disk_without_seed_is_sparse_corpus():
    got, marks = images.disk(SIZE, None)
    assert (got == corpus.sparse_corpus(SIZE)).all()
    assert (marks == np.arange(4096, SIZE - 8192, images.SLOT)).all()


def test_disk_seed_moves_each_message_within_its_slot():
    got, marks = images.disk(SIZE, 12345)
    slots = np.arange(4096, SIZE - 8192, images.SLOT)
    assert len(marks) == len(slots)
    longest = max(len(m) for m in images.MESSAGES)
    assert ((marks // images.SLOT) == (slots // images.SLOT)).all()
    assert ((marks + longest) // images.SLOT == marks // images.SLOT).all()
    assert (got[:4096] == 0).all() and (got[-4096:] == 0).all()
    first = next(k for k, m in enumerate(images.MESSAGES)
                 if bytes(got[marks[0]:marks[0] + len(m)]) == m)
    for k, off in enumerate(marks.tolist()):
        m = images.MESSAGES[(first + k) % len(images.MESSAGES)]
        assert bytes(got[off:off + len(m)]) == m


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**63 + 1, -3])
def test_image_seeds_differ_by_image_and_take_any_whole_number(seed):
    s = [images.image_seed(seed, k) for k in range(4)]
    assert len(set(s)) == 4
    assert s == [images.image_seed(seed, k) for k in range(4)]
