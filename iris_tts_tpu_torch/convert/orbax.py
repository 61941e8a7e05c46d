"""Orbax checkpoints to numpy, without jax, orbax or tensorstore.

The JAX package writes its artifacts' ``params`` and its train-stage
checkpoints with orbax's ``StandardCheckpointHandler``: a directory with
``_CHECKPOINT_METADATA``, the tree in ``_METADATA`` (JSON: each leaf's key
path and value type) and the arrays as zarr-v2 arrays in an OCDBT store
(``manifest.ocdbt``; :mod:`.ocdbt`). Each array ``a.b.c`` (the key path
joined by ``.``) has its ``a.b.c/.zarray`` JSON and its chunks
``a.b.c/<i>.<j>…`` (``0`` for a scalar), each zstd-compressed (:mod:`.zstd`)
or stored raw.

:func:`read_tree` gives what orbax's ``StandardCheckpointer().restore``
gives without a target: nested dicts (and lists for sequences) of numpy
arrays, Python scalars where the tree held them, ``None`` and empty
containers where it did. numpy has no bfloat16, so a ``bfloat16`` leaf
comes back as a ``torch.bfloat16`` tensor with the same bits.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from iris_tts_tpu_torch.convert import zstd
from iris_tts_tpu_torch.convert.ocdbt import OcdbtReader

PathLike = Union[str, Path]

# zarr-v2 dtypes that JAX train states hold.
DTYPES = {
    "<f2": np.dtype("<f2"),
    "<f4": np.dtype("<f4"),
    "<f8": np.dtype("<f8"),
    "<i4": np.dtype("<i4"),
    "<i8": np.dtype("<i8"),
    "<u4": np.dtype("<u4"),
    "|b1": np.dtype("?"),
    "bfloat16": np.dtype("<u2"),  # raw bits; returned as torch.bfloat16
}
_ARRAY_TYPES = ("np.ndarray", "jax.Array")
# Leaves orbax stores no data for, as its restore gives them back.
_SKIPPED = {"None": lambda: None, "Dict": dict, "List": list,
            "Tuple": tuple}
_KEY_DICT = 2  # key_type of a dict key; 1 is a sequence index


class OrbaxFormatError(ValueError):
    """A checkpoint this reader does not understand."""


def is_orbax_checkpoint(path: PathLike) -> bool:
    """Whether ``path`` is an orbax checkpoint directory this module reads:
    ``_METADATA`` and an OCDBT ``manifest.ocdbt`` in it, and
    ``_CHECKPOINT_METADATA`` in it or, for an item of a step that orbax's
    ``CheckpointManager`` wrote (``<step>/default``), in its parent."""
    p = Path(path)
    return ((p / "_METADATA").is_file() and (p / "manifest.ocdbt").is_file()
            and any((d / "_CHECKPOINT_METADATA").is_file()
                    for d in (p, p.parent)))


def _fill(meta: dict, name: str) -> Any:
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        raise OrbaxFormatError(f"{name}: fill_value {value!r} not supported")
    return value


def _decode_chunk(raw: bytes, compressor: Optional[dict], nbytes: int,
                  name: str) -> bytes:
    if compressor is None:
        data = raw
    elif compressor.get("id") == "zstd":
        data = zstd.decompress(raw, max_output_size=nbytes)
    else:
        raise OrbaxFormatError(f"{name}: compressor {compressor!r} not "
                               "supported")
    if len(data) != nbytes:
        raise OrbaxFormatError(f"{name}: chunk has {len(data)} bytes, "
                               f"want {nbytes}")
    return data


def read_array(store: OcdbtReader, name: str
               ) -> Union[np.ndarray, torch.Tensor]:
    """The zarr-v2 array ``name`` of ``store``: its chunks (``C`` order)
    assembled, a missing chunk holding ``fill_value``."""
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise OrbaxFormatError(f"no array {name!r} in {store.path}") from None
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format "
                               f"{meta.get('zarr_format')} not supported")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters not supported")
    if meta["dtype"] not in DTYPES:
        raise OrbaxFormatError(f"{name}: dtype {meta['dtype']!r} not "
                               "supported")
    dtype = DTYPES[meta["dtype"]]
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} do not fit shape "
                               f"{shape}")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r} not "
                               "supported")
    sep = meta.get("dimension_separator", ".")
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    fill = _fill(meta, name)
    if meta["dtype"] == "bfloat16" and fill != 0:
        raise OrbaxFormatError(f"{name}: bfloat16 fill_value {fill!r} not "
                               "supported")
    out = np.full(shape, fill, dtype=dtype)
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            continue  # never written: fill_value
        data = _decode_chunk(raw, meta.get("compressor"), nbytes, key)
        block = np.frombuffer(data, dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s))
                      for i, c, s in zip(idx, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _leaf_paths(metadata: dict) -> List[Tuple[List[Tuple[str, int]], dict]]:
    tree = metadata.get("tree_metadata")
    if not isinstance(tree, dict):
        raise OrbaxFormatError("_METADATA has no tree_metadata")
    out = []
    for text, entry in tree.items():
        keys = entry.get("key_metadata")
        if not keys:
            raise OrbaxFormatError(f"_METADATA: leaf {text} has no "
                                   "key_metadata")
        out.append(([(k["key"], int(k["key_type"])) for k in keys],
                    entry["value_metadata"]))
    return out


def _insert(root: dict, path: List[Tuple[str, int]], value: Any) -> None:
    node = root
    for (key, _), (_, child_type) in zip(path, path[1:]):
        node = node.setdefault(key, {} if child_type == _KEY_DICT else
                               {"__sequence__": True})
    node[path[-1][0]] = value


def _finish(node: Any) -> Any:
    """Sequence nodes (dicts of index → child) to lists, in index order."""
    if not isinstance(node, dict):
        return node
    if node.pop("__sequence__", False):
        return [_finish(node[k]) for k in sorted(node, key=int)]
    return {k: _finish(v) for k, v in node.items()}


def read_tree(path: PathLike) -> Dict[str, Any]:
    """The tree of the orbax checkpoint at ``path`` with numpy leaves
    (see the module docstring). Arrays decode on up to 8 threads (the
    decoder releases the interpreter lock)."""
    path = Path(path)
    if not is_orbax_checkpoint(path):
        raise OrbaxFormatError(f"{path} is not an orbax checkpoint with an "
                               "OCDBT store")
    metadata = json.loads((path / "_METADATA").read_text())
    if metadata.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: zarr3 arrays not supported")
    store = OcdbtReader(path)
    root: dict = {"__root__": {}}
    arrays = []
    for keys, value_meta in _leaf_paths(metadata):
        kind = value_meta.get("value_type")
        full = [("__root__", _KEY_DICT)] + keys
        if kind in _SKIPPED:
            _insert(root, full, _SKIPPED[kind]())
        elif kind in _ARRAY_TYPES or kind == "scalar":
            arrays.append((full, kind, ".".join(k for k, _ in keys)))
        else:
            raise OrbaxFormatError(f"{path}: leaf {keys} has value type "
                                   f"{kind!r}, not supported")
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        values = list(pool.map(lambda a: read_array(store, a[2]), arrays))
    for (full, kind, _), arr in zip(arrays, values):
        _insert(root, full, arr.item() if kind == "scalar" else arr)
    return _finish(root["__root__"])


def flat_leaves(tree: Any, path: Tuple[str, ...] = ()):
    """(key path, leaf) of every leaf of a :func:`read_tree` tree (dicts,
    lists and tuples; ``None`` is no leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def tree_sha256(tree: Any) -> str:
    """SHA-256 of a checkpoint tree: the raw bytes of every leaf (a
    ``bfloat16`` tensor's bits), leaves in the order of their key paths
    joined by ``.`` (the store's key order)."""
    digest = hashlib.sha256()
    for _, leaf in sorted(flat_leaves(tree), key=lambda e: ".".join(e[0])):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.view(torch.int16).numpy()
        digest.update(np.ascontiguousarray(leaf).tobytes())
    return digest.hexdigest()
