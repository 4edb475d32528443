"""Pytree and slab-state checkpoints (npz), the JAX package's format.

PyTorch counterpart of ``repro.checkpoint``. Two formats share one
atomic-write core, and both are the JAX package's key for key, so a file
either package writes loads in the other:

* ``save`` / ``load``: a generic pytree (params, ``ServerOptState``,
  counters), leaves flattened to ``|``-joined key paths (dict keys,
  sequence indices, ``.field`` for NamedTuple fields; a bf16 leaf as its
  ``uint16`` words under ``<path>~bf16``) in one compressed npz, and
  rebuilt on load in the structure, dtypes and devices of a template.
* ``save_slab_state`` / ``load_slab_state``: the resident
  ``SlabTrainState``, its raw slabs beside the JSON fingerprint of the
  ``SlabSpec`` (``core.slab_state.spec_meta``), which the load checks
  against the caller's spec: a resume never re-packs into a drifted
  layout.

``save_slab_state(blocking=False)`` copies the slabs to the host before
it returns and writes the file on a thread behind the loop; the bytes
are those of a blocking save (numpy's zip entries carry a fixed
timestamp).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.slab import SlabSpec, tree_flatten, tree_unflatten
from repro_torch.core.slab_state import (SlabTrainState, check_spec_meta,
                                         spec_meta)
from repro_torch.device import DeviceLike, resolve_device

PyTree = Any
_SEP = "|"
_BF16 = "~bf16"   # npz cannot store bfloat16; stored as its uint16 words

# In-flight async writers (save_slab_state(blocking=False)), joined at
# the next checkpoint boundary and by wait_for_async_saves(). They hold
# host copies only, never a device buffer.
_PENDING_SAVES: List[threading.Thread] = []
_PENDING_LOCK = threading.Lock()
_PENDING_ERRORS: List[BaseException] = []


def wait_for_async_saves() -> None:
    """Join every in-flight ``save_slab_state(blocking=False)`` write.

    Call at loop exit (and before reading a file that may still be in
    flight). Re-raises the first background write failure, so a crashed
    async save cannot pass silently.
    """
    while True:
        with _PENDING_LOCK:
            if not _PENDING_SAVES:
                break
            t = _PENDING_SAVES.pop(0)
        t.join()
    with _PENDING_LOCK:
        if _PENDING_ERRORS:
            err = _PENDING_ERRORS[:]
            _PENDING_ERRORS.clear()
            raise RuntimeError(
                f"{len(err)} async checkpoint write(s) failed; first "
                f"failure: {err[0]!r}") from err[0]


def _key_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in leaf order, keyed as the JAX package keys
    ``jax.tree_util.tree_flatten_with_path``: dict keys, sequence
    indices and ``.field`` for NamedTuple fields, ``|``-joined. None is
    an empty subtree, as in ``jax.tree``."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, tuple) and hasattr(type(node), "_fields"):
            for f in node._fields:
                walk(getattr(node, f), path + ["." + f])
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + [str(i)])
        else:
            out.append((_SEP.join(path), node))

    walk(tree, [])
    return out


def _host(x) -> np.ndarray:
    """A host copy of a tensor or array leaf (never a view of it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).copy()
        return np.array(x)
    return np.array(x)


def _is_bf16(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bfloat16
    return np.asarray(x).dtype.name == "bfloat16"


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in _key_paths(tree):
        arr = _host(leaf)
        if _is_bf16(leaf):
            out[key + _BF16] = arr.view(np.uint16)
        else:
            out[key] = arr
    return out


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write to a temp file in the same dir, then rename (atomic)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, tree: PyTree) -> None:
    """Atomic save of a generic pytree."""
    _atomic_savez(path, _flatten(tree))


def _restore(arr: np.ndarray, like, bf16: bool):
    """A stored array in the dtype (and, for a tensor, on the device) of
    the template leaf ``like``; ``bf16`` when ``arr`` holds bf16 words."""
    if bf16:
        arr = torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
        if not isinstance(like, torch.Tensor):
            arr = arr.float().numpy()       # numpy has no bfloat16
    if isinstance(like, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(arr, dtype=like.dtype)
    return arr


def load(path: str, template: PyTree) -> PyTree:
    """Restore into the structure, dtypes and devices of ``template``."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    leaves = []
    for key, leaf in _key_paths(template):
        if key + _BF16 in stored:
            leaves.append(_restore(stored[key + _BF16], leaf, True))
        elif key in stored:
            leaves.append(_restore(stored[key], leaf, False))
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
    # None is an empty subtree (no stored leaf), as in jax.tree
    flat, treedef = tree_flatten(template)
    it = iter(leaves)
    return tree_unflatten(treedef, [None if x is None else next(it)
                                    for x in flat])


def save_slab_state(path: str, state: SlabTrainState,
                    extra: Optional[Dict[str, Any]] = None,
                    blocking: bool = True) -> None:
    """Atomic save of a ``SlabTrainState`` (slabs stored raw, no unpack).

    The layout fingerprint (``slab_state.spec_meta``) rides along so
    ``load_slab_state`` can verify that the resuming process rebuilds the
    same layout. ``extra`` adds named arrays (tensors or arrays) under an
    ``x_`` prefix.

    ``blocking=False`` overlaps the compress and write with the training
    loop: the device-to-host copy of every slab happens here, before the
    call returns, and only the npz encode and the atomic rename run on a
    background thread. A previous in-flight write is joined first, so
    checkpoints reach the disk in order. The file's bytes are those of
    the blocking path. Join stragglers with ``wait_for_async_saves``.
    """
    arrays = {"step": _host(state.step), "w": _host(state.w),
              "alpha_hat": _host(state.alpha_hat),
              "spec_meta": np.asarray(json.dumps(spec_meta(state.spec)))}
    for i, slab in enumerate(state.opt):
        arrays[f"opt_{i}"] = _host(slab)
    arrays["n_opt"] = np.asarray(len(state.opt))
    if state.ef is not None:
        arrays["ef"] = _host(state.ef)
    for k, v in (extra or {}).items():
        arrays[f"x_{k}"] = _host(v)
    if blocking:
        _atomic_savez(path, arrays)
        return
    wait_for_async_saves()

    def write():
        try:
            _atomic_savez(path, arrays)
        except BaseException as ex:          # surfaced by the next join
            with _PENDING_LOCK:
                _PENDING_ERRORS.append(ex)

    t = threading.Thread(target=write, name="ckpt-async-save", daemon=True)
    with _PENDING_LOCK:
        _PENDING_SAVES.append(t)
    t.start()


def load_slab_state(path: str, spec: SlabSpec, device: DeviceLike = None
                    ) -> Tuple[SlabTrainState, Dict[str, np.ndarray]]:
    """Restore a ``SlabTrainState`` laid out by ``spec`` onto ``device``
    (default: the card).

    Raises ``ValueError`` if ``spec`` does not reproduce the checkpointed
    layout (shapes, dtypes, offsets, padding, shards, treedef): resuming
    into a drifted layout would scramble the slabs. Returns ``(state,
    extra)`` with ``extra`` the ``x_``-prefixed arrays given at save
    time, as numpy arrays.
    """
    dev = resolve_device(device)
    wait_for_async_saves()       # never read a file still in flight
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    check_spec_meta(spec, json.loads(str(stored["spec_meta"])), where=path)

    def tensor(x, dtype):
        return torch.from_numpy(np.asarray(x)).to(device=dev, dtype=dtype)

    n_opt = int(stored["n_opt"])
    state = SlabTrainState(
        step=tensor(stored["step"], torch.int32),
        w=tensor(stored["w"], torch.float32),
        opt=tuple(tensor(stored[f"opt_{i}"], torch.float32)
                  for i in range(n_opt)),
        # checkpoints from before the alpha loop carry no tracker state:
        # resume with the unseeded sentinel
        alpha_hat=tensor(stored.get("alpha_hat", np.zeros((), np.float32)),
                         torch.float32),
        spec=spec,
        # checkpoints without error feedback carry no residual rows
        ef=(tensor(stored["ef"], torch.float32) if "ef" in stored
            else None))
    extra = {k[2:]: v for k, v in stored.items() if k.startswith("x_")}
    return state, extra


def latest_round(ckpt_dir: str, prefix: str = "round_") -> Optional[str]:
    """The path of the highest-numbered ``<prefix><round>.npz`` in
    ``ckpt_dir``, or None."""
    wait_for_async_saves()       # an in-flight file must be listable
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = []
    for f in os.listdir(ckpt_dir):
        if f.startswith(prefix) and f.endswith(".npz"):
            try:
                rounds.append((int(f[len(prefix):-4]), f))
            except ValueError:
                continue
    if not rounds:
        return None
    return os.path.join(ckpt_dir, max(rounds)[1])
