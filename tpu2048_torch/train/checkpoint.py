"""Checkpoints in the JAX package's format, and the weight carrier.

Counterpart of ``tpu2048/train/checkpoint.py``. A checkpoint is
``<name>.npz`` (plus a human-readable ``<name>.json`` mirror of its
manifest). Format v2 stores every leaf under its JAX key path, such as
``['params']['blocks'][0]['lin']['w']``, and embeds the manifest under
``__manifest__``. Round-1 files (format v1) store the leaves as ``leaf_<i>``
in the JAX tree's flatten order; they are read, never written.

Writes are crash-atomic: the ``.npz`` goes to a temporary file that
``os.replace`` commits, and the manifest rides inside it, so an interrupted
save leaves the old checkpoint or the new one, never a truncated file.
Reads check every member's CRC-32 and also its local header against the
central directory: ``zipfile`` reads only the central copy of a member's
CRC, sizes and time, so bytes flipped in the local copy would load unseen.

The port's parameter names are those key paths joined with dots
(``blocks.0.lin.w``), so carrying weights across is a renaming:
:func:`params_to_state_dict`, and back, :func:`state_dict_to_params`.
"""

from __future__ import annotations

import json
import os
import re
import struct
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

FORMAT_VERSION = 2
_MANIFEST_KEY = "__manifest__"
_CORRUPTION_ERRORS = (zipfile.BadZipFile, zlib.error, EOFError, OSError)
_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")
_LOCAL_HEADER = struct.Struct("<4s5H3I2H")
_ZIP64_PLACEHOLDER = 0xFFFFFFFF


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is unreadable: truncated, bit-rotted, or not an npz."""


def parse_key_path(key: str) -> tuple:
    """``"['blocks'][0]['lin']['w']"`` -> ``("blocks", 0, "lin", "w")``."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        name, index, attr = m.groups()
        parts.append(int(index) if index is not None else (name if name is not None else attr))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"not a JAX key path: {key!r}")
    return tuple(parts)


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, path + (i,))
    else:
        yield path, node


def params_to_state_dict(params: dict) -> dict:
    """The weight carrier: the JAX package's MLP parameters, as a nested dict
    (the params pytree, leaves convertible by ``np.asarray``) or as a dict
    keyed by key path relative to the params tree, -> a ``state_dict`` of
    float tensors with the port's names."""
    if params and all(isinstance(k, str) and k.startswith("[") for k in params):
        items = [(parse_key_path(k), v) for k, v in params.items()]
    else:
        items = list(_flatten(params))
    return {".".join(map(str, path)): torch.tensor(np.asarray(v))
            for path, v in items}


def state_dict_to_params(model) -> dict:
    """The weight carrier's reverse: a model (or its ``state_dict``) -> the
    JAX package's params tree, nested dicts and lists of contiguous float32
    numpy arrays (``tree['blocks'][0]['lin']['w']``). Each tensor is copied
    to the host once; :func:`params_to_state_dict` gives it back exactly."""
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    tree: dict = {}
    for name, t in sd.items():
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32, copy=True).contiguous().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def jax_flatten_order(names) -> list:
    """``names`` (dotted parameter names) in the order ``jax.tree_util``
    flattens the matching pytree: dict keys sorted, list items in order."""
    def key(name):
        return tuple(int(p) if p.isdigit() else p for p in name.split("."))
    return sorted(names, key=key)


def _zip64_sizes(extra: bytes, csize: int, usize: int) -> tuple:
    """(compressed, uncompressed) sizes of a local header whose 32-bit
    fields hold the zip64 placeholder: from its zip64 extra record."""
    pos = 0
    while pos + 4 <= len(extra):
        tag, size = struct.unpack_from("<2H", extra, pos)
        if tag == 1:
            values = list(struct.unpack_from(f"<{size // 8}Q", extra, pos + 4))
            if usize == _ZIP64_PLACEHOLDER and values:
                usize = values.pop(0)
            if csize == _ZIP64_PLACEHOLDER and values:
                csize = values.pop(0)
            break
        pos += 4 + size
    return csize, usize


def check_local_headers(path) -> None:
    """Raise ``zipfile.BadZipFile`` where a member's local header (version,
    flags, method, time, date, CRC-32, sizes) differs from its entry in the
    central directory."""
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            f.seek(info.header_offset)
            (sig, version, flags, method, dostime, dosdate, crc, csize, usize, n_name,
             n_extra) = _LOCAL_HEADER.unpack(f.read(_LOCAL_HEADER.size))
            f.seek(n_name, os.SEEK_CUR)
            csize, usize = _zip64_sizes(f.read(n_extra), csize, usize)
            y, mo, d, h, mi, sec = info.date_time
            fixed = (sig, version, flags, method, dostime, dosdate)
            want = (b"PK\x03\x04", info.extract_version, info.flag_bits, info.compress_type,
                    (h << 11) | (mi << 5) | (sec // 2), ((y - 1980) << 9) | (mo << 5) | d)
            sized = not flags & 0x08  # else the CRC and sizes follow the data
            if fixed != want or (sized and (crc, csize, usize) != (
                    info.CRC, info.compress_size, info.file_size)):
                raise zipfile.BadZipFile(f"local header of {info.filename!r} differs "
                                         "from the central directory")


def read_npz(path) -> tuple:
    """(arrays keyed as stored, embedded manifest or None). A missing file
    raises FileNotFoundError; unreadable, truncated or bit-rotted files raise
    :class:`CheckpointCorruptError`."""
    try:
        check_local_headers(path)
        data = np.load(path)
        files = set(data.files)
    except FileNotFoundError:
        raise
    except _CORRUPTION_ERRORS + (ValueError,) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e}); "
            "it may be truncated or corrupted on disk") from e
    try:
        with data:
            manifest = (json.loads(str(data[_MANIFEST_KEY]))
                        if _MANIFEST_KEY in files else None)
            arrays = {k: data[k] for k in files if k != _MANIFEST_KEY}
    except _CORRUPTION_ERRORS as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed a CRC/read check mid-load "
            f"({type(e).__name__}: {e}); it is corrupted on disk") from e
    return arrays, manifest


def checkpoint_exists(ckpt_dir, name: str) -> bool:
    """True if ``<name>.npz`` is there with a manifest: embedded, or in the
    ``.json`` mirror."""
    d = Path(ckpt_dir)
    npz = d / f"{name}.npz"
    if not npz.exists():
        return False
    if (d / f"{name}.json").exists():
        return True
    try:
        with zipfile.ZipFile(npz) as z:
            return f"{_MANIFEST_KEY}.npy" in z.namelist()
    except _CORRUPTION_ERRORS:
        return False


def state_dict_from_arrays(arrays: dict, names, source) -> dict:
    """The ``params`` subtree of a checkpoint's ``arrays`` (from
    :func:`read_npz` of file ``source``) as a state_dict holding exactly
    ``names``, the model's parameter names.

    Format v2: the leaves under ``['params']``. Format v1: a params-only file
    whose ``leaf_<i>`` follow the JAX flatten order of ``names``. A missing
    or extra parameter raises with its name."""
    names = list(names)
    if arrays and all(k.startswith("leaf_") for k in arrays):
        if len(arrays) != len(names):
            raise ValueError(
                f"v1 checkpoint {source} has {len(arrays)} leaves, the model "
                f"needs {len(names)}: structure changed, cannot load by order")
        order = jax_flatten_order(names)
        return {n: torch.tensor(arrays[f"leaf_{i}"]) for i, n in enumerate(order)}
    prefix = "['params']"
    params = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
    sd = params_to_state_dict(params)
    missing = sorted(set(names) - set(sd))
    extra = sorted(set(sd) - set(names))
    if missing or extra:
        raise ValueError(
            f"checkpoint {source} does not match the model: missing "
            f"{missing[:5]}, unexpected {extra[:5]}")
    return sd


def key_path(name: str) -> str:
    """A dotted parameter name as its JAX key path relative to the params
    tree: ``blocks.0.lin.w`` -> ``['blocks'][0]['lin']['w']``."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split("."))


def save_pytree(leaves: dict, path, *, manifest: dict | None = None) -> None:
    """Save ``leaves`` ({JAX key path: array}) as one ``.npz``, the manifest
    embedded as JSON under ``__manifest__``; crash-atomic (a temporary file
    committed with ``os.replace``)."""
    path = Path(path)
    arrays = {k: np.asarray(v) for k, v in leaves.items()}
    if manifest is not None:
        arrays[_MANIFEST_KEY] = np.array(json.dumps(manifest))
    tmp = path.with_name(path.stem + ".tmp.npz")
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def save_checkpoint(ckpt_dir, name: str, *, leaves: dict, manifest: dict) -> Path:
    """Write ``<name>.npz`` (format v2, manifest embedded) into ``ckpt_dir``,
    then its ``<name>.json`` mirror, each atomically."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    manifest = dict(manifest, format_version=FORMAT_VERSION)
    save_pytree(leaves, d / f"{name}.npz", manifest=manifest)
    tmp = d / f"{name}.tmp.json"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, d / f"{name}.json")
    return d / f"{name}.npz"


def load_checkpoint(ckpt_dir, name: str) -> tuple:
    """(arrays keyed by JAX key path, manifest) of ``<name>.npz``: the
    embedded manifest, else the ``.json`` mirror of an older file."""
    d = Path(ckpt_dir)
    arrays, manifest = read_npz(d / f"{name}.npz")
    if manifest is None:
        with open(d / f"{name}.json") as f:
            manifest = json.load(f)
    return arrays, manifest
