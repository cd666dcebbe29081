"""Binary container: the Python surface over the native persistence tier.

Counterpart of vectorindex_tpu.persistence.container (parity target: the
reference's IndexMmap open/close and section accessors, VIndexMmap.swift:
222-486, mmap_append_begin/commit :606/:748, mmap_wal_replay :830, and
VIndexContainerBuilder.swift:59). The file format is the JAX package's:
a container written by either package opens in the other.

  - The native core is the port's own copy, persistence/native/container.cpp.
    It is built with g++ at first use into build/container/<hash of source
    and flags>/ under the repository root (never into the package); a failed
    build raises with the compiler's output. vc_open bounds-checks every
    table-of-contents entry against the file, so a truncated or corrupt file
    raises CORRUPT_DATA at open.
  - Sections are typed flat arrays. `read_array` returns a zero-copy numpy
    view of the mapping: copy it before the container closes.
  - bfloat16 (dtype tag 8): `add_array` writes a torch.bfloat16 tensor's raw
    16-bit patterns; `read_array` gives them back as numpy uint16 bits and
    `read_tensor` as a torch.bfloat16 tensor. Neither ml_dtypes nor jax is
    imported.
"""

from __future__ import annotations

import ctypes
import enum
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from vectorindex_tpu_torch.utils.errors import ErrorBuilder, IndexErrorKind

CONTAINER_SRC = Path(__file__).resolve().parent / "native" / "container.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "container"
GXX_FLAGS = ("-O2", "-std=c++20", "-fPIC", "-shared")
LIB_NAME = "libvindex_container.so"


class SectionType(enum.IntEnum):
    """Typed sections (the JAX package's values)."""

    CENTROIDS = 1
    CODEBOOKS = 2
    CENTROID_NORMS = 3
    LISTS_DESC = 4
    IDS = 5
    CODES = 6
    VECS = 7
    NORMS_INV = 8
    NORMS_SQ = 9
    IDMAP = 10
    TOMBSTONES = 11
    TELEMETRY = 12
    FREELIST = 13
    WAL = 14
    META = 15
    GRAPH_NBRS = 16  # per-layer fixed-degree neighbor tables (nth = layer)
    GRAPH_NODES = 17  # per-layer row -> slot tables (nth = layer)
    LEVELS = 18  # per-slot level assignment


#: dtype tags stored in the section descriptor (the JAX package's)
_DTYPES = {
    np.dtype("float32"): 1,
    np.dtype("float16"): 2,
    np.dtype("int32"): 3,
    np.dtype("int64"): 4,
    np.dtype("uint8"): 5,
    np.dtype("uint32"): 6,
    np.dtype("uint64"): 7,
}
BF16_TAG = 8
_DTYPES_INV = {v: k for k, v in _DTYPES.items()}
_DTYPES_INV[BF16_TAG] = np.dtype("uint16")  # bf16 bits
_ERRKIND = {
    -1: IndexErrorKind.IO_ERROR,
    -2: IndexErrorKind.CORRUPT_DATA,
    -3: IndexErrorKind.VERSION_MISMATCH,
    -4: IndexErrorKind.ENDIANNESS_MISMATCH,
    -5: IndexErrorKind.CHECKSUM_MISMATCH,
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(CONTAINER_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _build() -> Path:
    """Compile into a temp file beside the target, then os.replace it into
    place (processes may race the build; none may load a half-written
    library). A failed build raises with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=".build_", dir=out.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(CONTAINER_SRC)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"building {CONTAINER_SRC.name} needs g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {CONTAINER_SRC} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The native container library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, u32, u64, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
    P = ctypes.POINTER
    sigs = {
        "vc_create": (vp, [ctypes.c_char_p, u32, u64]),
        "vc_open": (vp, [ctypes.c_char_p, i32, P(i32)]),
        "vc_close": (None, [vp]),
        "vc_sync": (i32, [vp]),
        "vc_generation": (u64, [vp]),
        "vc_bump_generation": (None, [vp]),
        "vc_section_count": (u32, [vp]),
        "vc_add_section": (i32, [vp, u32, u32, vp, u64, u64, u64, u64]),
        "vc_find_section": (i32, [vp, u32, u32]),
        "vc_section_info": (i32, [vp, i32, P(vp), P(u64), P(u64), P(u32), P(u64), P(u64),
                                  P(u32)]),
        "vc_verify_section": (i32, [vp, i32]),
        "vc_append_begin": (u64, [vp, i32, u64]),
        "vc_append_commit": (i32, [vp, i32, u64, vp, u64]),
        "vc_wal_replay": (i32, [vp]),
        "vc_wal_reset": (i32, [vp]),
        "vc_crc32": (u32, [vp, u64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _raise(code: int, msg: str):
    raise (
        ErrorBuilder(_ERRKIND.get(code, IndexErrorKind.IO_ERROR))
        .message(msg)
        .detail("code", code)
        .build()
    )


def _as_numpy(array) -> tuple[np.ndarray, int]:
    """(row-major numpy array, dtype tag): a torch.bfloat16 tensor becomes
    its 16-bit patterns under tag 8."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16_TAG
        array = t.numpy()
    a = np.ascontiguousarray(array)
    if a.dtype not in _DTYPES:
        raise TypeError(f"no container dtype tag for {a.dtype}")
    return a, _DTYPES[a.dtype]


class Container:
    """mmap-backed typed-section container (reference IndexMmap)."""

    def __init__(self, handle: int, writable: bool):
        self._h = handle
        self._writable = writable
        self._lib = load_library()

    # -- lifecycle --

    @classmethod
    def create(cls, path: str, cap_sections: int = 64, wal_capacity: int = 1 << 20) -> "Container":
        lib = load_library()
        h = lib.vc_create(os.fsencode(path), cap_sections, wal_capacity)
        if not h:
            _raise(-1, f"failed to create container {path}")
        return cls(h, True)

    @classmethod
    def open(cls, path: str, writable: bool = False, replay: bool = True) -> "Container":
        lib = load_library()
        err = ctypes.c_int(0)
        h = lib.vc_open(os.fsencode(path), 1 if writable else 0, ctypes.byref(err))
        if not h:
            _raise(err.value, f"failed to open container {path}")
        c = cls(h, writable)
        if replay:
            applied = lib.vc_wal_replay(h)
            if applied < 0:
                c.close()
                _raise(applied, "WAL replay found corrupt committed data")
        return c

    def close(self) -> None:
        if self._h:
            self._lib.vc_close(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def sync(self) -> None:
        self._lib.vc_sync(self._h)

    @property
    def generation(self) -> int:
        return self._lib.vc_generation(self._h)

    def bump_generation(self) -> None:
        self._lib.vc_bump_generation(self._h)

    @property
    def section_count(self) -> int:
        return self._lib.vc_section_count(self._h)

    # -- sections --

    def add_array(self, type: SectionType, array: Union[np.ndarray, torch.Tensor],
                  capacity_bytes: int = 0) -> int:
        """Add a section holding an array (row-major numpy array or torch
        tensor). nrows/stride are recorded so readers rebuild the shape."""
        a, dtype_tag = _as_numpy(array)
        nrows = a.shape[0] if a.ndim else 1
        stride = a.nbytes // max(nrows, 1)
        idx = self._lib.vc_add_section(
            self._h, int(type), dtype_tag, a.ctypes.data_as(ctypes.c_void_p), a.nbytes,
            capacity_bytes, nrows, stride,
        )
        if idx < 0:
            _raise(-1, f"add_section failed for {type.name}")
        return idx

    def add_blob(self, type: SectionType, blob: bytes, capacity_bytes: int = 0) -> int:
        return self.add_array(type, np.frombuffer(blob, dtype=np.uint8), capacity_bytes)

    def find(self, type: SectionType, nth: int = 0) -> int:
        return self._lib.vc_find_section(self._h, int(type), nth)

    def _info(self, idx: int):
        ptr, cap = ctypes.c_void_p(), ctypes.c_uint64()
        nbytes, nrows, stride = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        dtype, typ = ctypes.c_uint32(), ctypes.c_uint32()
        r = self._lib.vc_section_info(
            self._h, idx, ctypes.byref(ptr), ctypes.byref(nbytes), ctypes.byref(cap),
            ctypes.byref(dtype), ctypes.byref(nrows), ctypes.byref(stride), ctypes.byref(typ),
        )
        if r != 0:
            _raise(-1, f"no section at index {idx}")
        return ptr, nbytes, cap, dtype, nrows, stride, typ

    def _section(self, type: SectionType, nth: int, verify: bool) -> tuple[np.ndarray, int]:
        idx = self.find(type, nth)
        if idx < 0:
            _raise(-1, f"section {type.name} not found")
        if verify:
            v = self._lib.vc_verify_section(self._h, idx)
            if v != 0:
                _raise(v, f"section {type.name} failed CRC")
        ptr, nbytes, _, dtype, nrows, stride, _ = self._info(idx)
        if dtype.value not in _DTYPES_INV:
            _raise(-2, f"section {type.name} has unknown dtype tag {dtype.value}")
        dt = _DTYPES_INV[dtype.value]
        flat = np.frombuffer((ctypes.c_char * nbytes.value).from_address(ptr.value), dtype=dt) \
            if nbytes.value else np.zeros(0, dtype=dt)
        n = int(nrows.value)
        if n > 0 and stride.value and nbytes.value == n * stride.value:
            cols = int(stride.value // dt.itemsize)
            if cols > 1:
                return flat.reshape(n, cols), dtype.value
        return flat, dtype.value

    def read_array(self, type: SectionType, nth: int = 0, verify: bool = False) -> np.ndarray:
        """Zero-copy numpy view of a section (bf16 as uint16 bits). The view
        aliases the mapping: copy it before closing the container."""
        return self._section(type, nth, verify)[0]

    def read_tensor(self, type: SectionType, nth: int = 0, verify: bool = False) -> torch.Tensor:
        """A section as a CPU tensor that owns its memory (bf16 sections as
        torch.bfloat16)."""
        a, tag = self._section(type, nth, verify)
        if tag == BF16_TAG:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    def read_blob(self, type: SectionType, nth: int = 0) -> bytes:
        return self.read_array(type, nth).tobytes()

    def verify_all(self) -> None:
        for i in range(self.section_count):
            v = self._lib.vc_verify_section(self._h, i)
            if v != 0:
                _raise(v, f"section {i} failed CRC")

    # -- durable append (reference mmap_append_begin/commit) --

    def append(self, type_or_idx, data: np.ndarray) -> int:
        """WAL-durable append of rows to a growable section. Returns the byte
        offset of the appended data within the section."""
        idx = self.find(type_or_idx) if isinstance(type_or_idx, SectionType) else type_or_idx
        a = np.ascontiguousarray(data)
        off = self._lib.vc_append_begin(self._h, idx, a.nbytes)
        if off == ctypes.c_uint64(-1).value:
            _raise(-1, "append_begin failed (WAL full or io error)")
        if self._lib.vc_append_commit(self._h, idx, off, a.ctypes.data_as(ctypes.c_void_p),
                                      a.nbytes) != 0:
            _raise(-1, "append_commit failed")
        return off

    def wal_replay(self) -> int:
        return self._lib.vc_wal_replay(self._h)

    def wal_reset(self) -> None:
        self._lib.vc_wal_reset(self._h)

    # -- compaction --

    def compact_to(self, path: str) -> "Container":
        """Rewrite the live sections into a fresh container (grow-with-copy
        relocations leave dead space behind). Keeps section order, types,
        dtypes and shapes; the generation goes up by one and the WAL starts
        empty. Returns the new container, open for writing."""
        w_idx = self.find(SectionType.WAL)
        wal_cap = int(self._info(w_idx)[2].value) if w_idx >= 0 else 1 << 20
        out = Container.create(path, wal_capacity=wal_cap)
        for i in range(self.section_count):
            ptr, nbytes, _, dtype, nrows, stride, typ = self._info(i)
            if typ.value == int(SectionType.WAL):
                continue
            idx = out._lib.vc_add_section(out._h, typ.value, dtype.value, ptr, nbytes.value, 0,
                                          nrows.value, stride.value)
            if idx < 0:
                out.close()
                _raise(-1, "compact_to: add_section failed")
        for _ in range(self.generation):
            out.bump_generation()
        out.sync()
        return out
