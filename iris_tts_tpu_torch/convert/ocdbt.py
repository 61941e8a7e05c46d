"""Read-only reader of OCDBT key-value stores (tensorstore's B-tree format).

Orbax writes a checkpoint's arrays into such a store: ``manifest.ocdbt``
at the database's root, B-tree nodes and out-of-line values in data files
under it (``d/…``, ``ocdbt.process_0/d/…``). This reader takes the latest
version, which tensorstore always keeps inline in the manifest, and needs
neither tensorstore nor the ``zstandard`` package: compressed nodes go
through the port's own decoder (:mod:`.zstd`).

Every encoded file or node is ``magic`` (u32, big-endian), its total
``length`` (u64), a ``version`` and a ``compression`` varint (0 none,
1 zstd), the body, and a CRC-32C of all that precedes it (u32). In the
bodies, integers are LEB128 varints, and arrays of records are stored
column by column:

* manifest: the config (uuid, manifest kind, value and node limits, the
  version tree's arity, the compression), then, for a single-file
  manifest, the version tree's newest leaf entries inline (references to
  version-tree nodes, which hold only older versions, follow and are not
  read). A numbered manifest keeps the config in ``manifest.ocdbt`` and
  each version tree in ``manifest.<generation as 16 hex digits>``;
* data file table: paths by prefix compression against the previous path,
  each a base path and a path relative to it, both under the database's
  root;
* B-tree node: height, data file table, then the entries. Keys are
  prefix-compressed against the previous key and are relative to the
  node's own prefix, which its parent entry states. A leaf entry holds
  its value inline or as a reference (file, offset, length); an interior
  entry references a child node.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from iris_tts_tpu_torch.convert import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1
_HEADER = 4 + 8
_TRAILER = 4

Key = Union[str, bytes]


class OcdbtError(ValueError):
    """A malformed or unsupported OCDBT database."""


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")

    def varint(self) -> int:
        result = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if b < 0x80:
                return result
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def i32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes after the end")


def decode_encoded(data: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded file or node, checked against its magic,
    length and CRC-32C trailer, decompressed."""
    if len(data) < _HEADER + 2 + _TRAILER:
        raise OcdbtError(f"{what}: truncated")
    got_magic, length = struct.unpack(">I", data[:4])[0], \
        struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, want {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what}: states {length} bytes, has {len(data)}")
    crc = struct.unpack("<I", data[-_TRAILER:])[0]
    if zstd.crc32c(data[:-_TRAILER]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    c = _Cursor(data[:-_TRAILER], what)
    c.pos = _HEADER
    version = c.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} not supported")
    compression = c.varint()
    body = data[c.pos:-_TRAILER]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: compression {compression} not supported")


def _data_file_table(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # base path lengths: the joined path is what locates it
    paths: List[bytes] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: bad data file path prefix")
        prev = prev[:prefix[i]] + c.raw(suffix[i])
        paths.append(prev)
    out = [p.decode() for p in paths]
    for p in out:
        if p.startswith("/") or ".." in p.split("/"):
            raise OcdbtError(f"{c.what}: data file {p!r} outside the "
                             "database")
    return out


@dataclass(frozen=True)
class _Ref:
    file: str
    offset: int
    length: int


@dataclass(frozen=True)
class _Root:
    generation: int
    height: int
    ref: Optional[_Ref]  # None: the version's tree is empty


def _version_leaf_entries(c: _Cursor, files: List[str]) -> List[_Root]:
    n = c.varint()
    gens = c.varints(n)
    heights = c.raw(n)
    fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
    c.varints(n)  # keys
    c.varints(n)  # tree bytes
    c.varints(n)  # indirect value bytes
    c.u64s(n)  # commit times
    out = []
    for i in range(n):
        ref = None
        if lens[i] != _MISSING:
            if fids[i] >= len(files):
                raise OcdbtError(f"{c.what}: data file id out of range")
            ref = _Ref(files[fids[i]], offs[i], lens[i])
        out.append(_Root(gens[i], heights[i], ref))
    return out


@dataclass
class _Leaf:
    keys: List[bytes]  # full keys, ascending
    values: List[Union[bytes, _Ref]]


@dataclass
class _Interior:
    mins: List[bytes]  # full inclusive-minimum keys, ascending
    prefixes: List[bytes]  # each child's own key prefix
    children: List[_Ref]


class OcdbtReader:
    """The latest version of the OCDBT database under ``path``:
    :meth:`list` its keys, :meth:`read` a value."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._nodes: Dict[Tuple[_Ref, bytes], Union[_Leaf, _Interior]] = {}
        manifest = self.path / "manifest.ocdbt"
        if not manifest.is_file():
            raise FileNotFoundError(f"no OCDBT manifest at {manifest}")
        c = _Cursor(decode_encoded(manifest.read_bytes(), MANIFEST_MAGIC,
                                   str(manifest)), str(manifest))
        kind = self._config(c)
        if kind == 1:  # numbered: the config alone here
            c.end()
            c = self._latest_numbered_manifest()
            self._config(c)
        elif kind != 0:
            raise OcdbtError(f"{manifest}: manifest kind {kind} not supported")
        self.root = self._latest_root(c)

    # -- manifest -------------------------------------------------------------

    @staticmethod
    def _config(c: _Cursor) -> int:
        """Skips the config; returns the manifest kind."""
        c.raw(16)  # uuid
        kind = c.varint()
        c.varint()  # max inline value bytes
        c.varint()  # max decoded node bytes
        c.raw(1)  # the version tree's arity, log2
        method = c.varint()
        if method == 1:
            c.i32()  # zstd level
        elif method != 0:
            raise OcdbtError(f"{c.what}: compression method {method} "
                             "not supported")
        return kind

    def _latest_numbered_manifest(self) -> _Cursor:
        numbered = []
        for p in self.path.glob("manifest.*"):
            suffix = p.name[len("manifest."):]
            if len(suffix) == 16 and all(ch in "0123456789abcdef"
                                         for ch in suffix):
                numbered.append((int(suffix, 16), p))
        if not numbered:
            raise OcdbtError(f"{self.path}: numbered manifest with no "
                             "manifest.<generation> file")
        p = max(numbered)[1]
        return _Cursor(decode_encoded(p.read_bytes(), MANIFEST_MAGIC, str(p)),
                       str(p))

    @staticmethod
    def _latest_root(c: _Cursor) -> _Root:
        versions = _version_leaf_entries(c, _data_file_table(c))
        if not versions:
            raise OcdbtError(f"{c.what}: no version inline")
        return max(versions, key=lambda v: v.generation)

    # -- B-tree ---------------------------------------------------------------

    def _read_range(self, ref: _Ref) -> bytes:
        p = self.path / ref.file
        with open(p, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtError(f"{p}: {ref.length} bytes at {ref.offset} run "
                             "past the file's end")
        return data

    def _read_encoded(self, ref: _Ref, magic: int) -> bytes:
        return decode_encoded(self._read_range(ref), magic,
                              f"{self.path / ref.file}@{ref.offset}")

    def _node(self, ref: _Ref, prefix: bytes, height: int
              ) -> Union[_Leaf, _Interior]:
        cached = self._nodes.get((ref, prefix))
        if cached is not None:
            return cached
        what = f"{self.path / ref.file}@{ref.offset}"
        c = _Cursor(self._read_encoded(ref, BTREE_NODE_MAGIC), what)
        got = c.raw(1)[0]
        if got != height:
            raise OcdbtError(f"{what}: height {got}, its parent says "
                             f"{height}")
        files = _data_file_table(c)
        n = c.varint()
        kpre = [0] + c.varints(n - 1) if n else []
        ksuf = c.varints(n)
        common = c.varints(n) if height else None
        keys: List[bytes] = []
        prev = b""
        for i in range(n):
            if kpre[i] > len(prev):
                raise OcdbtError(f"{what}: bad key prefix length")
            prev = prev[:kpre[i]] + c.raw(ksuf[i])
            keys.append(prev)

        def file_of(fid: int) -> str:
            if fid >= len(files):
                raise OcdbtError(f"{what}: data file id out of range")
            return files[fid]

        node: Union[_Leaf, _Interior]
        if height == 0:
            lengths = c.varints(n)
            kinds = c.raw(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            fids = c.varints(len(indirect))
            offs = c.varints(len(indirect))
            values: List[Union[bytes, _Ref]] = [b""] * n
            for j, i in enumerate(indirect):
                values[i] = _Ref(file_of(fids[j]), offs[j], lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = c.raw(lengths[i])
            c.end()
            node = _Leaf([prefix + k for k in keys], values)
        else:
            fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            c.varints(n)  # keys below each child
            c.varints(n)  # tree bytes
            c.varints(n)  # indirect value bytes
            c.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise OcdbtError(f"{what}: bad subtree prefix length")
            node = _Interior(
                [prefix + k for k in keys],
                [prefix + k[:common[i]] for i, k in enumerate(keys)],
                [_Ref(file_of(fids[i]), offs[i], lens[i]) for i in range(n)])
        self._nodes[(ref, prefix)] = node
        return node

    def _walk(self, lo: bytes, hi: Optional[bytes]):
        """(key, value) of the leaves with lo <= key < hi (hi None: no
        upper bound), ascending."""
        if self.root is None or self.root.ref is None:
            return
        stack = [(self.root.ref, b"", self.root.height)]
        while stack:
            ref, prefix, height = stack.pop()
            node = self._node(ref, prefix, height)
            if isinstance(node, _Leaf):
                i = bisect.bisect_left(node.keys, lo)
                j = (len(node.keys) if hi is None
                     else bisect.bisect_left(node.keys, hi))
                yield from zip(node.keys[i:j], node.values[i:j])
                continue
            picked = []
            for i, child in enumerate(node.children):
                nxt = node.mins[i + 1] if i + 1 < len(node.mins) else None
                if (hi is None or node.mins[i] < hi) and (nxt is None
                                                          or nxt > lo):
                    picked.append((child, node.prefixes[i], height - 1))
            stack.extend(reversed(picked))

    # -- API ----------------------------------------------------------------

    @staticmethod
    def _key(key: Key) -> bytes:
        return key.encode() if isinstance(key, str) else bytes(key)

    def list(self, prefix: Key = b"") -> List[str]:
        """The keys that start with ``prefix``, ascending."""
        lo = self._key(prefix)
        return [k.decode(errors="surrogateescape")
                for k, _ in self._walk(lo, _successor(lo))]

    def read(self, key: Key) -> bytes:
        """The value stored under ``key``; ``KeyError`` if there is none."""
        k = self._key(key)
        for got, value in self._walk(k, k + b"\x00"):
            if got == k:
                return (self._read_range(value)
                        if isinstance(value, _Ref) else value)
        raise KeyError(key)


def _successor(prefix: bytes) -> Optional[bytes]:
    """The least key above every key that starts with ``prefix`` (None:
    no such key)."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)
