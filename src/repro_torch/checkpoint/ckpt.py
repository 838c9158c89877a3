"""Checkpointing: atomic, keep-N, COMMITTED-gated (counterpart of
``repro/checkpoint/ckpt.py``, with the same on-disk layout).

Layout (one directory per step):
    <dir>/step_000123/
        arrays.npz      leaves as flat uint8 views, keyed ``leaf_%05d``
        meta.msgpack    leaf paths, dtypes, shapes, step, user metadata
        COMMITTED       sentinel written last (torn saves are never loaded)

Writes go to ``step_X.tmp`` and are renamed, so a crash mid-save leaves
the previous checkpoint intact; ``latest_step`` only sees COMMITTED
checkpoints. Leaves are visited in ``tree.tree_leaves`` order and named by
``tree.tree_leaves_with_path`` paths, which are the JAX package's order
and ``keystr`` paths, and the metadata goes through ``mpack`` (byte-equal
to ``msgpack.packb``): a checkpoint written by either package is read by
the other. Leaves are tensors (or Python scalars) and come back as
tensors of the target leaf's dtype on its device. A leaf of a dtype that
numpy knows only through ``ml_dtypes`` (bfloat16, the float8 family) is
stored as the reference stores it, as its raw bytes under JAX's dtype
name, and restored bitwise through torch's dtype of that name, so no
``ml_dtypes`` is needed; a dtype that torch cannot name raises.
"""
from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import mpack
from repro_torch.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

# dtypes numpy holds without ml_dtypes
_NP_DTYPES = frozenset((
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128"))

# dtypes numpy holds only through ml_dtypes, which torch names the same
# way (JAX's names): stored as raw bytes, viewed back through torch
_TORCH_ONLY = {name: getattr(torch, name) for name in (
    "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz", "float8_e8m0fnu") if hasattr(torch, name)}


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def _unnamed(dtype: str, what: str) -> ValueError:
    return ValueError(f"{what}: dtype {dtype} has no torch counterpart, so "
                      f"the port can neither write nor read it")


def _to_bytes(x, path: str):
    """A leaf -> (flat uint8 array of its bytes, dtype name, shape)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        x = x.detach().cpu().contiguous()
        if name in _TORCH_ONLY:
            raw = x.reshape(-1).view(torch.uint8).numpy()
            return raw, name, list(x.shape)
        if name not in _NP_DTYPES:
            raise _unnamed(name, f"leaf {path}")
        x = x.numpy()
    x = np.asarray(x)
    arr = np.ascontiguousarray(x)
    # the original shape (ascontiguousarray makes a 0-d leaf 1-d)
    return arr.view(np.uint8).reshape(-1), str(arr.dtype), list(x.shape)


def save(ckpt_dir: str | Path, step: int, tree: Any,
         metadata: Optional[Dict] = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    with_paths = tree_leaves_with_path(tree)
    arrays, paths, dtypes, shapes = {}, [], [], []
    for i, (path, x) in enumerate(with_paths):
        raw, dtype, shape = _to_bytes(x, path)
        paths.append(path)
        dtypes.append(dtype)
        shapes.append(shape)
        arrays[_leaf_key(i)] = raw
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "n_leaves": len(with_paths), "paths": paths,
            "dtypes": dtypes, "shapes": shapes, "user": metadata or {}}
    (tmp / "meta.msgpack").write_bytes(mpack.packb(meta))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)
    # torn-save debris (step_X.tmp, or a step dir without COMMITTED) is
    # never loaded, but would pile up across crash-restart loops: each
    # successful save sweeps it, never touching a committed dir
    for p in ckpt_dir.iterdir():
        torn = (re.fullmatch(r"step_\d+\.tmp", p.name) or
                (re.fullmatch(r"step_\d+", p.name)
                 and not (p / "COMMITTED").exists()))
        if torn:
            shutil.rmtree(p, ignore_errors=True)


def all_steps(ckpt_dir: str | Path):
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "COMMITTED").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _resolve_step(ckpt_dir: Path, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return step


def _load_meta(d: Path) -> Dict:
    """Read and decode ``meta.msgpack`` of one step directory under the
    COMMITTED contract: a torn layout (missing sentinel, missing or
    truncated metadata) raises instead of surfacing garbage."""
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(
            f"{d} is not a committed checkpoint (missing COMMITTED — "
            f"torn save?)")
    try:
        raw = (d / "meta.msgpack").read_bytes()
    except FileNotFoundError:
        raise FileNotFoundError(f"{d} has no meta.msgpack — torn save?")
    try:
        meta = mpack.unpackb(raw)
    except Exception as e:
        raise ValueError(
            f"corrupt checkpoint metadata in {d / 'meta.msgpack'}: "
            f"{e}") from e
    if not isinstance(meta, dict) or "user" not in meta:
        raise ValueError(
            f"corrupt checkpoint metadata in {d / 'meta.msgpack'}: "
            f"not a checkpoint meta dict")
    return meta


def read_metadata(ckpt_dir: str | Path,
                  step: Optional[int] = None) -> Dict:
    """The ``metadata`` dict a committed checkpoint was saved with,
    without touching the array payload."""
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    return _load_meta(ckpt_dir / f"step_{step:09d}")["user"]


def _leaf(data, meta: Dict, i: int, ref, name: str):
    """Leaf ``i`` of the payload as ``ref``'s kind: a tensor of its dtype
    on its device (uint32 bits keep their int32 storage), or a Python
    scalar for a scalar ``ref``."""
    dtype, shape = meta["dtypes"][i], tuple(meta["shapes"][i])
    raw = data[_leaf_key(i)]
    if dtype in _TORCH_ONLY:
        t = torch.from_numpy(np.array(raw)).view(_TORCH_ONLY[dtype])
        t = t.reshape(shape)
    elif dtype in _NP_DTYPES:
        arr = raw.view(np.dtype(dtype)).reshape(shape)
        if arr.dtype == np.uint32 and isinstance(ref, torch.Tensor) \
                and ref.dtype == torch.int32:
            arr = arr.view(np.int32)
        t = torch.from_numpy(np.array(arr))
    else:
        raise _unnamed(dtype, f"leaf {name}")
    if tuple(t.shape) != tuple(np.shape(ref)):
        raise ValueError(f"leaf {name}: checkpoint shape {tuple(t.shape)} "
                         f"!= target {tuple(np.shape(ref))}")
    if not isinstance(ref, torch.Tensor):
        return type(ref)(t.item())
    return t.to(device=ref.device, dtype=ref.dtype)


def restore(ckpt_dir: str | Path, target: Any, step: Optional[int] = None):
    """Restore into the structure of ``target`` (a pytree of tensors or
    scalars) -> (tree, step, user_metadata)."""
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    d = ckpt_dir / f"step_{step:09d}"
    meta = _load_meta(d)
    leaves = tree_leaves(target)
    if len(leaves) != meta["n_leaves"]:
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, target has "
            f"{len(leaves)} — structure mismatch")
    with np.load(d / "arrays.npz") as data:
        out = [_leaf(data, meta, i, ref, meta["paths"][i])
               for i, ref in enumerate(leaves)]
    return tree_unflatten(target, out), step, meta["user"]


def restore_subtree(ckpt_dir: str | Path, target: Any, prefix: str,
                    step: Optional[int] = None):
    """Restore ONE subtree of a checkpoint (``"['policy']"`` out of an
    ``rl_train`` checkpoint) without reading the rest of the payload ->
    (subtree, step, user_metadata). Leaves are matched by path (``prefix``
    + the leaf's path inside ``target``), and each selected ``arrays.npz``
    member decompresses on its own, so an inference process never
    materialises training state."""
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    d = ckpt_dir / f"step_{step:09d}"
    meta = _load_meta(d)
    index = {p: i for i, p in enumerate(meta["paths"])}
    out = []
    with np.load(d / "arrays.npz") as data:
        for sub_path, ref in tree_leaves_with_path(target):
            full = prefix + sub_path
            i = index.get(full)
            if i is None:
                raise ValueError(
                    f"checkpoint step {step} has no leaf {full!r} — "
                    f"wrong prefix or structure mismatch "
                    f"(saved paths start with e.g. {meta['paths'][0]!r})")
            out.append(_leaf(data, meta, i, ref, full))
    return tree_unflatten(target, out), step, meta["user"]
