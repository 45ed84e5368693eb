"""A read-only OCDBT key-value store, the on-disk B+tree that orbax writes.

The JAX package saves its checkpoints through orbax into an OCDBT store
(tensorstore's "optionally cooperative distributed B+tree"). The card's
machine has neither orbax nor tensorstore, so the port reads the store
with this module (numpy and the standard library, zstd by
``training/zstd.py``). ``OcdbtStore(path).list()`` gives the keys and
``read(key)`` a value's bytes.

On disk every manifest and B+tree node is one record:

- a 4-byte big-endian magic: ``0x0cdb3a2a`` for a manifest, ``0x0cdb20de``
  for a node;
- the record's length in bytes, 8 bytes little-endian;
- a varint version (0) and a varint compression (0 none, 1 zstd);
- the body, one zstd frame where compressed;
- the CRC-32C (Castagnoli) of everything before it, 4 bytes little-endian.

``manifest.ocdbt`` holds the config (a UUID, the manifest kind, the inline
and node size limits, the version-tree arity, the compression and its
level), then a table of data files and the latest versions. The newest
version names the root node: a data file, an offset and a length. A data
file holds nodes and the values too large to sit in their node. Columns
are stored one after another: a field of every entry, then the next field.
A node has a height (0 for a leaf), its own table of data files, its
entries' keys (each as the length it shares with the key before, its
suffix's length and the suffixes), and

- in a leaf, each value's length and kind (0 inline, 1 in a data file),
  the data file and offset of each indirect value, then the inline values;
- in an interior node, each child's subtree prefix length (the keys of a
  child drop the part every key under it shares), the child's data file,
  offset and length, and its statistics.

Every file is read whole and every record's magic, length and CRC-32C are
checked before it is parsed; a torn or corrupt file raises ``OcdbtError``
naming it, and no partial value is returned.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from brax_tracking_tpu_torch.training import zstd

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
MANIFEST = "manifest.ocdbt"


class OcdbtError(ValueError):
    """A torn, corrupt or unsupported OCDBT store."""


# --- CRC-32C -----------------------------------------------------------------


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t


_CRC_TABLE = _crc_table().tolist()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of ``data``."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- records -----------------------------------------------------------------


class _Cursor:
    """Reads varints and fixed-size fields from a record body."""

    def __init__(self, body: bytes, name: str):
        self.body, self.i, self.name = body, 0, name

    def fail(self, what: str):
        raise OcdbtError(f"{self.name}: {what}")

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.body):
            self.fail("record ends early")
        out = self.body[self.i:self.i + n]
        self.i += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def keys(self, n: int, with_column: bool = False):
        """``n`` prefix-coded byte strings, and the column of ``n`` varints
        stored between their lengths and their bytes where there is one
        (a path's base-path length, an interior entry's subtree prefix
        length)."""
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        column = self.varints(n) if with_column else None
        out, prev = [], b""
        for s, n_suffix in zip(shared, suffix):
            if s > len(prev):
                self.fail("key shares more than the key before it")
            prev = prev[:s] + self.take(n_suffix)
            out.append(prev)
        return out, column

    def data_files(self) -> List[str]:
        # each path is whole; its base-path length is not needed
        paths, _ = self.keys(self.varint(), with_column=True)
        return [p.decode() for p in paths]


def _unwrap(raw: bytes, magic: int, name: str) -> bytes:
    """The body of one record, checked."""
    if len(raw) < 18:
        raise OcdbtError(f"{name}: record of {len(raw)} bytes is torn")
    if int.from_bytes(raw[:4], "big") != magic:
        raise OcdbtError(f"{name}: bad magic {raw[:4].hex()} (expected {magic:08x})")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise OcdbtError(f"{name}: record says {int.from_bytes(raw[4:12], 'little')} bytes, "
                         f"holds {len(raw)}")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{name}: CRC-32C mismatch")
    cur = _Cursor(raw[12:-4], name)
    if cur.varint() != 0:
        raise OcdbtError(f"{name}: unsupported format version")
    compression = cur.varint()
    body = raw[12 + cur.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{name}: {e}") from None
    raise OcdbtError(f"{name}: unknown compression {compression}")


class OcdbtStore:
    """The newest version of the OCDBT store in directory ``path``."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._files: Dict[str, bytes] = {}
        self._entries = None
        body = _unwrap(self._file(MANIFEST), MANIFEST_MAGIC, self._name(MANIFEST))
        cur = _Cursor(body, self._name(MANIFEST))
        cur.take(16)  # the store's UUID
        if cur.varint() != 0:
            cur.fail("numbered manifests are not supported (orbax writes single ones)")
        cur.varint(), cur.varint()  # max inline value bytes, max decoded node bytes
        cur.byte()  # version tree arity log2
        if cur.varint() == 1:
            cur.take(4)  # zstd level, int32 little-endian
        files = cur.data_files()
        n = cur.varint()
        if n == 0:
            self._root = None
            return
        cur.varints(n)  # generation numbers, oldest first
        heights = list(cur.take(n))
        file_ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        if file_ids[-1] >= len(files):
            cur.fail("root node in an unknown data file")
        # the newest version: its root node, or an empty tree
        self._root = ((files[file_ids[-1]], offsets[-1], lengths[-1]), heights[-1])
        if lengths[-1] == 0:
            self._root = None

    def _name(self, rel: str) -> str:
        return os.path.join(self.path, rel)

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            name = self._name(rel)
            try:
                with open(name, "rb") as f:
                    self._files[rel] = f.read()
            except OSError as e:
                raise OcdbtError(f"{name}: {e.strerror}") from None
        return self._files[rel]

    def _extent(self, ref: Tuple[str, int, int]) -> bytes:
        rel, offset, length = ref
        data = self._file(rel)
        if offset + length > len(data):
            raise OcdbtError(f"{self._name(rel)}: {length} bytes at {offset} run past its "
                             f"{len(data)} bytes (torn file)")
        return data[offset:offset + length]

    def _walk(self, ref, height: int, prefix: bytes, out: Dict[bytes, object]) -> None:
        name = f"{self._name(ref[0])} (node at {ref[1]})"
        cur = _Cursor(_unwrap(self._extent(ref), NODE_MAGIC, name), name)
        if cur.byte() != height:
            cur.fail(f"node height differs from its parent's record ({height})")
        files = cur.data_files()
        n = cur.varint()
        if height == 0:
            keys, _ = cur.keys(n)
            lengths = cur.varints(n)
            kinds = list(cur.take(n))
            if any(k > 1 for k in kinds):
                cur.fail("unknown value kind")
            m = sum(kinds)
            ids, offsets = cur.varints(m), cur.varints(m)
            indirect = iter(zip(ids, offsets))
            for key, length, kind in zip(keys, lengths, kinds):
                if kind:
                    fid, off = next(indirect)
                    if fid >= len(files):
                        cur.fail("value in an unknown data file")
                    out[prefix + key] = (files[fid], off, length)
                else:
                    out[prefix + key] = cur.take(length)
            if cur.i != len(cur.body):
                cur.fail("bytes after the leaf's values")
            return
        keys, subtree = cur.keys(n, with_column=True)
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        for _ in range(3):  # statistics: keys, tree bytes, indirect value bytes
            cur.varints(n)
        for key, keep, fid, off, length in zip(keys, subtree, ids, offsets, lengths):
            if fid >= len(files) or keep > len(key):
                cur.fail("bad child reference")
            self._walk((files[fid], off, length), height - 1, prefix + key[:keep], out)

    def _index(self) -> Dict[bytes, object]:
        if self._entries is None:
            entries: Dict[bytes, object] = {}
            if self._root is not None:
                ref, height = self._root
                self._walk(ref, height, b"", entries)
            self._entries = entries
        return self._entries

    def list(self) -> List[str]:
        """Every key of the store, sorted."""
        return sorted(k.decode() for k in self._index())

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` naming it where it is absent."""
        v = self._index().get(key.encode())
        if v is None:
            raise KeyError(f"{key} is not in the OCDBT store {self.path}")
        return v if isinstance(v, bytes) else self._extent(v)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index()
