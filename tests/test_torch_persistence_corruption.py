"""The port's container under corruption, as
tests/test_persistence_corruption.py checks the JAX package's: truncation at
structural boundaries, TOC and section corruption, torn WAL tails,
zero-byte and tiny files.

The port checks more at open than the JAX package: vc_open bounds-checks
the header and every table-of-contents entry against the file size, so a
truncated file, or an entry that points past the end, raises CORRUPT_DATA
at open instead of reading past the mapping.
"""

import os
import struct

import numpy as np
import pytest
import torch

from vectorindex_tpu.persistence.container import Container as JContainer
from vectorindex_tpu_torch.models import FlatIndex, load_index
from vectorindex_tpu_torch.persistence.container import Container, SectionType
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind

torch.set_num_threads(1)

TRUNCATIONS = [0.1, 0.5, 0.9]


def _make(path: str, container=Container) -> str:
    with container.create(path) as c:
        c.add_array(SectionType.CENTROIDS, np.arange(64, dtype=np.float32).reshape(8, 8))
        c.add_array(SectionType.IDS, np.arange(32, dtype=np.int64))
        c.add_blob(SectionType.TELEMETRY, b"telemetry-blob" * 8)
    return path


def _truncate(path: str, frac: float) -> None:
    with open(path, "r+b") as f:
        f.truncate(max(64, int(os.path.getsize(path) * frac)))


def test_zero_byte_file_rejected(tmp_path):
    p = tmp_path / "zero.vx"
    p.write_bytes(b"")
    with pytest.raises(IndexError) as ei:
        Container.open(str(p))
    assert ei.value.kind in (IndexErrorKind.CORRUPT_DATA, IndexErrorKind.IO_ERROR)


def test_tiny_file_rejected(tmp_path):
    p = tmp_path / "tiny.vx"
    p.write_bytes(b"INDEXTPU")  # magic alone, no header
    with pytest.raises(IndexError) as ei:
        Container.open(str(p))
    assert ei.value.kind == IndexErrorKind.CORRUPT_DATA


@pytest.mark.parametrize("frac", TRUNCATIONS)
def test_truncated_file_detected(tmp_path, frac):
    """Truncation inside the WAL or inside section data raises CORRUPT_DATA
    at open: no entry is followed past the end of the file."""
    p = _make(str(tmp_path / "t.vx"))
    _truncate(p, frac)
    with pytest.raises(IndexError) as ei:
        Container.open(p)
    assert ei.value.kind == IndexErrorKind.CORRUPT_DATA


@pytest.mark.parametrize("frac", TRUNCATIONS)
def test_truncated_index_container_raises_at_load(tmp_path, frac):
    """A truncated index container, the JAX package's or the port's, raises
    CORRUPT_DATA from load_index and the container's own loader."""
    x = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    idx = FlatIndex(8, device="cpu")
    idx.insert_batch(list(range(64)), x)
    p = str(tmp_path / "flat.vx")
    idx.save_container(p)
    jp = _make(str(tmp_path / "j.vx"), container=JContainer)
    for path in (p, jp):
        _truncate(path, frac)
    for load in (lambda: load_index(p, device="cpu"), lambda: FlatIndex.load_container(p, "cpu"),
                 lambda: Container.open(jp)):
        with pytest.raises(IndexError) as ei:
            load()
        assert ei.value.kind == IndexErrorKind.CORRUPT_DATA


@pytest.mark.parametrize("field, value", [(8, 1 << 40), (24, 1 << 40), (16, 1 << 20)],
                         ids=["offset_past_end", "capacity_past_end", "nbytes_past_capacity"])
def test_toc_entry_out_of_bounds_rejected_at_open(tmp_path, field, value):
    """A TOC entry (CRC-free: the header CRC does not cover it) whose
    section would end past the file, or hold more bytes than its capacity,
    is CORRUPT_DATA at open."""
    p = _make(str(tmp_path / "b.vx"))
    with open(p, "r+b") as f:
        f.seek(256 + 64 * 2 + field)  # the IDS section's descriptor
        f.write(struct.pack("<Q", value))
    with pytest.raises(IndexError) as ei:
        Container.open(p)
    assert ei.value.kind == IndexErrorKind.CORRUPT_DATA


def test_corrupt_toc_entry_detected(tmp_path):
    """Bytes flipped inside the TOC region (after the fixed header)."""
    p = _make(str(tmp_path / "toc.vx"))
    with open(p, "r+b") as f:
        f.seek(300)  # inside the TOC, past the 256-byte header
        f.write(b"\xff" * 16)
    with pytest.raises(IndexError):
        with Container.open(p) as c:
            c.verify_all()


def test_corrupt_each_section_detected_independently(tmp_path):
    """One corrupt section fails its own verified read; the others stay
    readable (per-section CRCs, reference VIndexMmap.swift:52-68)."""
    p = _make(str(tmp_path / "sec.vx"))
    raw = open(p, "rb").read()
    off = raw.find(np.arange(32, dtype=np.int64).tobytes())
    assert off > 0
    with open(p, "r+b") as f:
        f.seek(off + 8)
        f.write(b"\xde\xad\xbe\xef")
    with Container.open(p) as c:
        assert c.read_array(SectionType.CENTROIDS).shape == (8, 8)
        with pytest.raises(IndexError) as ei:
            c.read_array(SectionType.IDS, verify=True)
        assert ei.value.kind in (IndexErrorKind.CORRUPT_DATA, IndexErrorKind.CHECKSUM_MISMATCH)
        c.read_array(SectionType.CENTROIDS, verify=True)


def test_flipped_bit_in_blob_detected(tmp_path):
    p = _make(str(tmp_path / "blob.vx"))
    raw = open(p, "rb").read()
    off = raw.find(b"telemetry-blob")
    assert off > 0
    with open(p, "r+b") as f:
        f.seek(off + 3)
        b = f.read(1)
        f.seek(off + 3)
        f.write(bytes([b[0] ^ 0x01]))  # one bit
    with Container.open(p) as c:
        with pytest.raises(IndexError):
            c.read_array(SectionType.TELEMETRY, verify=True)


def test_wal_torn_tail_discarded(tmp_path):
    """A torn trailing WAL record is discarded by replay; committed records
    before it still apply."""
    p = str(tmp_path / "wal.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32), capacity_bytes=4096)
        c.append(idx, np.arange(8, 16, dtype=np.int32))
    with open(p, "ab") as f:
        f.write(b"\x5a" * 37)
    with Container.open(p, writable=False, replay=True) as c:
        got = c.read_array(SectionType.IDS)
        assert got.shape[0] >= 8 and (got[:8] == np.arange(8)).all()


def test_reopen_after_clean_close_is_stable(tmp_path):
    """Open/close cycles leave the bytes as they were."""
    p = _make(str(tmp_path / "stable.vx"))
    before = open(p, "rb").read()
    for _ in range(3):
        with Container.open(p) as c:
            c.read_array(SectionType.CENTROIDS)
    assert open(p, "rb").read() == before


def test_bf16_section_roundtrip(tmp_path):
    """bf16 sections round-trip bit-exact, with no ml_dtypes in the port."""
    p = str(tmp_path / "bf16.vx")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    with Container.create(p) as c:
        c.add_array(SectionType.VECS, xb)
    with Container.open(p) as c:
        got = c.read_tensor(SectionType.VECS, verify=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), xb.view(torch.int16))


def test_large_section_grows_and_survives_reopen(tmp_path):
    """Appends past the reserved capacity relocate the section (reference
    VIndexMmap.swift:633-712); the data verifies after reopening."""
    p = str(tmp_path / "grow.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(4, dtype=np.int64), capacity_bytes=64)
        for i in range(6):
            c.append(idx, np.arange(4, dtype=np.int64) + 10 * (i + 1))
    with Container.open(p) as c:
        got = c.read_array(SectionType.IDS)
        assert got.shape[0] == 4 * 7
        assert (got[:4] == np.arange(4)).all() and (got[-4:] == np.arange(4) + 60).all()
        c.verify_all()
