"""Checkpoint and restore of named worker-namespace entries (counterpart
of ``nbdistributed_tpu/runtime/checkpoint.py``).

**Per-rank, coordination-free.**  Each rank writes ``{path}/rank_{r}/``
on its own: namespace values are rank-local, a checkpoint must be
takeable from a subset of ranks and restorable into a world of another
size (each rank reads its own directory), and a save must not hang on a
dead rank.

The on-disk layout is the JAX package's (``{path}/rank_{r}/``):

- ``manifest.json``: format version, rank, world size, and per saved
  name its leaves in JAX's pytree order (:mod:`..utils.pytree`): a
  ``kind`` per leaf (``torch``, ``np`` or ``obj``), and for an array
  its dtype string as JAX names it (``"bfloat16"``), its shape and the
  ``crc32`` of its bytes; a tensor records its ``device`` where a JAX
  array records its ``sharding``;
- ``arrays.npz``: one raw uint8 entry ``{name}.{i}`` per array leaf
  (bf16 and float8 bytes go out through an integer view, as the wire
  codec sends them), so the same values give the same dtype, shape and
  crc32 in both packages' manifests;
- ``aux.pkl``: the tree descriptions (builtins only: tuples, strings
  and dict keys) and the non-array leaves.  Pickle is the trust model
  of ``torch.load``: restore only files you wrote.

A ``torch.optim.Optimizer`` value saves as its ``state_dict()`` (its
tensors on the array path): the counterpart of an optax state pytree.

**Restore into live state.**  The port's training updates its tensors
in place, and an optimizer holds the very tensors of the parameter
tree.  So where the namespace already holds a value of the same
structure, with tensors of the same shapes and dtypes where the
checkpoint has tensors, :func:`restore` copies into those tensors (and
loads an optimizer's state with ``load_state_dict``); otherwise it binds
new tensors on the recorded device, or on ``device=``.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from ..messaging.codec import from_storage, storage_dtype, wire_array
from ..utils.pytree import tree_flatten, tree_unflatten

# Array leaves carry a per-leaf "crc32" in the manifest: restore
# refuses torn or bit-rotted bytes with an error naming the leaf.  The
# key is optional on read (the JAX package's version-1 checkpoints
# written before it).
FORMAT_VERSION = 1


def _rank_dir(path: str, rank: int) -> str:
    return os.path.join(os.path.expanduser(path), f"rank_{rank}")


def _byte_serializable(dtype) -> bool:
    """True when raw bytes + ``str(dtype)`` round-trip the array.
    Structured, void and object dtypes go through the pickle path."""
    if dtype.hasobject or dtype.names is not None or dtype.kind == "V":
        return False
    try:
        return np.dtype(str(dtype)) == dtype
    except TypeError:
        return False


def _as_bytes(host: np.ndarray) -> np.ndarray:
    """uint8 view of an array's bytes (a strided one pays one copy)."""
    return np.ascontiguousarray(host).reshape(-1).view(np.uint8)


class _Staged:
    """A device tensor's bytes staged in pinned host memory by
    :func:`save_async`: the host tensor, the event its copy records and
    the device it came from (what the manifest records)."""

    __slots__ = ("host", "event", "device", "keep")

    def __init__(self, host, event, device, keep):
        self.host, self.event, self.device = host, event, device
        self.keep = keep        # the device clone, alive until the copy ends


def _array_entry(leaf) -> tuple[np.ndarray, dict] | None:
    """``(bytes, manifest entry)`` of an array leaf, or None for a leaf
    that goes through the pickle path."""
    if isinstance(leaf, _Staged):
        leaf.event.synchronize()
        leaf.keep = None                # the device clone can go now
        arr, name = wire_array(leaf.host)
        return _as_bytes(arr), {"kind": "torch", "dtype": name,
                                "shape": list(leaf.host.shape),
                                "device": leaf.device}
    if isinstance(leaf, torch.Tensor):
        arr, name = wire_array(leaf)
        return _as_bytes(arr), {"kind": "torch", "dtype": name,
                                "shape": list(leaf.shape),
                                "device": str(leaf.device)}
    if isinstance(leaf, np.ndarray) and _byte_serializable(leaf.dtype):
        return _as_bytes(leaf), {"kind": "np", "dtype": str(leaf.dtype),
                                 "shape": list(leaf.shape)}
    return None


def _missing(namespace, names, rank):
    missing = [n for n in names if n not in namespace]
    if missing:
        raise KeyError(f"names not defined on rank {rank}: {missing}")


def save(path: str, namespace: dict, names: list[str], *, rank: int = 0,
         world_size: int = 1) -> dict:
    """Snapshot ``names`` out of ``namespace`` into ``{path}/rank_{rank}``
    (``checkpoint.py:94``).  Returns per name its leaf count and array
    bytes."""
    _missing(namespace, names, rank)
    d = _rank_dir(path, rank)
    # Stage into a sibling tmp dir and swap it in only once written: a
    # failed or interrupted save never damages a good checkpoint.
    tmp = d + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    manifest: dict = {"version": FORMAT_VERSION, "rank": rank,
                      "world_size": world_size, "entries": {}}
    arrays: dict[str, np.ndarray] = {}
    trees: dict[str, tuple] = {}
    objects: dict[str, Any] = {}
    summary: dict[str, dict] = {}
    for name in names:
        leaves, spec = tree_flatten(namespace[name])
        trees[name] = spec
        leaf_meta, nbytes = [], 0
        for i, leaf in enumerate(leaves):
            key = f"{name}.{i}"
            entry = _array_entry(leaf)
            if entry is None:
                objects[key] = leaf
                leaf_meta.append({"kind": "obj"})
                continue
            raw, meta = entry
            arrays[key] = raw
            meta["crc32"] = zlib.crc32(raw)
            leaf_meta.append(meta)
            nbytes += raw.nbytes
        manifest["entries"][name] = {"leaves": leaf_meta}
        summary[name] = {"leaves": len(leaves), "bytes": nbytes}

    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(tmp, "aux.pkl"), "wb") as f:
        pickle.dump({"trees": trees, "objects": objects}, f)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    old = d + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(d):
        os.rename(d, old)
    os.rename(tmp, d)
    shutil.rmtree(old, ignore_errors=True)
    return summary


class AsyncSave:
    """Handle of a background :func:`save` (``checkpoint.py:176``):
    ``done()`` polls; ``wait(timeout)`` joins and returns the summary,
    re-raising what the save raised."""

    def __init__(self, thread, result_box):
        self._thread = thread
        self._box = result_box

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self, timeout: float | None = None) -> dict:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("async checkpoint still writing")
        if "error" in self._box:
            raise self._box["error"]
        return self._box["summary"]


def _stage_cuda(leaves: list) -> list:
    """Each CUDA tensor of ``leaves`` cloned on the current stream and
    copied, on a side stream, into one pinned host buffer, so that the
    copies run beside whatever the caller queues next.  Returns the
    leaves with :class:`_Staged` stand-ins in those places."""
    idx = [i for i, x in enumerate(leaves)
           if isinstance(x, torch.Tensor) and x.device.type == "cuda"]
    if not idx:
        return leaves
    # The clones own bytes that no later in-place step can touch.
    clones = [leaves[i].detach().clone(memory_format=torch.contiguous_format)
              for i in idx]
    sizes = [c.numel() * c.element_size() for c in clones]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + -(-n // 64) * 64)     # 64-byte aligned
    buf = torch.empty(offs[-1] + sizes[-1], dtype=torch.uint8,
                      pin_memory=True)
    cloned, side = torch.cuda.Event(), torch.cuda.Stream()
    cloned.record()
    side.wait_event(cloned)
    event = torch.cuda.Event()
    hosts = []
    with torch.cuda.stream(side):
        for c, off, n in zip(clones, offs, sizes):
            host = buf[off:off + n]
            host.copy_(c.reshape(-1).view(torch.uint8), non_blocking=True)
            hosts.append(host.view(c.dtype).view(c.shape))
        event.record()
    out = list(leaves)
    for i, c, host in zip(idx, clones, hosts):
        out[i] = _Staged(host, event, str(leaves[i].device), c)
    return out


def save_async(path: str, namespace: dict, names: list[str], *,
               rank: int = 0, world_size: int = 1) -> AsyncSave:
    """Start :func:`save` in a background thread; returns a handle
    (``checkpoint.py:204``).

    The values are taken at call time.  The port's train steps update
    their tensors in place, the hazard JAX's buffer donation poses, so
    each CUDA tensor is cloned on the current stream and its bytes
    copied, on a side stream, into pinned host memory (one buffer)
    behind a recorded event the thread waits on before it reads; the
    next step may run at once.  CPU tensors and numpy leaves are
    copied, and other Python leaves go through a pickle round trip.
    Cost: one transient device copy of the saved tensors until their
    host copy ends."""
    import threading

    _missing(namespace, names, rank)
    snapshot: dict = {}
    for n in names:
        leaves, spec = tree_flatten(namespace[n])
        frozen = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                frozen.append(leaf if leaf.device.type == "cuda"
                              else leaf.detach().clone())
            elif isinstance(leaf, np.ndarray):
                frozen.append(leaf.copy())
            else:
                frozen.append(pickle.loads(pickle.dumps(leaf)))
        snapshot[n] = (_stage_cuda(frozen), spec)
    namespace_then = {n: tree_unflatten(spec, leaves)
                      for n, (leaves, spec) in snapshot.items()}

    box: dict = {}

    def run():
        try:
            box["summary"] = save(path, namespace_then, names, rank=rank,
                                  world_size=world_size)
        except BaseException as e:  # surfaced at wait()
            box["error"] = e

    t = threading.Thread(target=run, name=f"nbd-ckpt-save-r{rank}",
                         daemon=True)
    t.start()
    return AsyncSave(t, box)


def _decode_array(raw: np.ndarray, meta: dict):
    """The leaf of ``meta`` from its raw bytes, on the host: a numpy
    array for ``np``, a CPU tensor for ``torch``."""
    host = raw.view(storage_dtype(meta["dtype"])).reshape(meta["shape"])
    if meta["kind"] == "np":
        return host
    if meta["kind"] != "torch":
        raise ValueError(f"cannot restore a {meta['kind']!r} leaf (written "
                         f"by the JAX package) into the PyTorch port")
    t = from_storage(host, meta["dtype"])
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(t)


def _place(leaf, meta: dict, device):
    """A decoded tensor leaf moved to ``device`` (None: the one its
    manifest entry records); other leaves as they are."""
    if meta["kind"] != "torch":
        return leaf
    dev = torch.device(device if device is not None
                       else meta.get("device", "cpu"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"the checkpoint's tensors were saved on {dev} and "
                         f"this process has no CUDA device: pass device= "
                         f"(e.g. device='cpu') to restore them elsewhere")
    return leaf if dev.type == "cpu" else leaf.to(dev)


def _fits(live, new) -> bool:
    """True when ``live`` has ``new``'s structure, with a tensor of the
    same shape and dtype wherever ``new`` has a tensor (an optimizer
    where ``new`` has its state dict)."""
    if isinstance(live, torch.optim.Optimizer):
        return type(new) is dict and "state" in new
    if isinstance(new, torch.Tensor):
        return (isinstance(live, torch.Tensor) and live.shape == new.shape
                and live.dtype == new.dtype)
    if type(new) is dict:
        return (type(live) is dict and set(live) == set(new)
                and all(_fits(live[k], new[k]) for k in new))
    if type(new) in (list, tuple):
        return (type(live) is type(new) and len(live) == len(new)
                and all(_fits(a, b) for a, b in zip(live, new)))
    return True


def _write_into(live, new):
    """``new`` written into ``live`` (which :func:`_fits` it): tensors by
    ``copy_``, an optimizer by ``load_state_dict``, dicts and lists item
    by item; returns the value to bind (``live`` where it could be kept)."""
    if isinstance(live, torch.optim.Optimizer):
        live.load_state_dict(new)
        return live
    if isinstance(new, torch.Tensor):
        with torch.no_grad():
            live.copy_(new)
        return live
    if type(new) is dict:
        for k in new:
            live[k] = _write_into(live[k], new[k])
        return live
    if type(new) is list:
        live[:] = [_write_into(a, b) for a, b in zip(live, new)]
        return live
    if type(new) is tuple:
        return tuple(_write_into(a, b) for a, b in zip(live, new))
    return new


def _load_manifest(path: str, rank: int) -> tuple[str, dict]:
    d = _rank_dir(path, rank)
    mpath = os.path.join(d, "manifest.json")
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"no checkpoint for rank {rank} at {path!r} "
                                f"(missing {mpath})")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version "
                         f"{manifest.get('version')!r}")
    return d, manifest


def restore(path: str, namespace: dict, names: list[str] | None = None, *,
            rank: int = 0, device=None) -> dict:
    """Load entries from ``{path}/rank_{rank}`` back into ``namespace``
    (``checkpoint.py:279``); ``names=None`` restores every entry.  A
    live value that fits an entry is written in place (module
    docstring); other entries bind new values, tensors on ``device``
    (None: each leaf's recorded device).  Returns the per-name summary
    :func:`save` returns."""
    d, manifest = _load_manifest(path, rank)
    apath = os.path.join(d, "aux.pkl")
    try:
        with open(apath, "rb") as f:
            aux = pickle.load(f)
    except Exception as e:
        raise ValueError(
            f"torn checkpoint: {apath} is missing or unreadable "
            f"({type(e).__name__}: {e}) — the manifest names entries "
            f"this file should hold; refusing to restore") from e
    if "trees" not in aux:
        raise ValueError(f"{apath} holds JAX tree definitions: the "
                         f"checkpoint was written by the JAX package")

    entries = manifest["entries"]
    if names is None:
        names = list(entries)
    missing = [n for n in names if n not in entries]
    if missing:
        raise KeyError(f"names not in checkpoint: {missing} "
                       f"(has {sorted(entries)})")

    zpath = os.path.join(d, "arrays.npz")
    try:
        npz_cm = np.load(zpath)
    except Exception as e:
        raise ValueError(
            f"torn checkpoint: {zpath} is missing or unreadable "
            f"({type(e).__name__}: {e}); refusing to restore") from e
    summary: dict[str, dict] = {}
    restored: dict[str, Any] = {}
    with npz_cm as npz:
        for name in names:
            leaf_meta = entries[name]["leaves"]
            leaves, nbytes = [], 0
            for i, meta in enumerate(leaf_meta):
                key = f"{name}.{i}"
                if meta["kind"] == "obj":
                    leaves.append(aux["objects"][key])
                    continue
                try:
                    raw = npz[key]
                except KeyError:
                    raise ValueError(
                        f"torn checkpoint: {zpath} has no entry {key!r} "
                        f"though the manifest declares it; refusing to "
                        f"restore") from None
                except Exception as e:
                    raise ValueError(
                        f"checkpoint integrity failure: entry {key!r} in "
                        f"{zpath} is unreadable ({type(e).__name__}: "
                        f"{e}); refusing to restore") from e
                want = meta.get("crc32")
                if want is not None:
                    got = zlib.crc32(np.ascontiguousarray(raw))
                    if got != want:
                        raise ValueError(
                            f"checkpoint integrity failure: {name!r} leaf "
                            f"{i} ({key} in {zpath}) has crc32 "
                            f"{got:#010x}, manifest says {want:#010x} — "
                            f"bytes changed on disk (bit rot or torn "
                            f"write); refusing to restore")
                leaves.append(_decode_array(raw, meta))
                nbytes += raw.nbytes
            restored[name] = leaves
            summary[name] = {"leaves": len(leaf_meta), "bytes": nbytes}
    # Every entry is read and checked before any live value changes.
    for name, leaves in restored.items():
        spec = aux["trees"][name]
        value = tree_unflatten(spec, leaves)
        if name in namespace and _fits(namespace[name], value):
            namespace[name] = _write_into(namespace[name], value)
        else:
            metas = entries[name]["leaves"]
            namespace[name] = tree_unflatten(spec, [
                _place(x, m, device) for x, m in zip(leaves, metas)])
    return summary


def verify_rank(path: str, rank: int) -> list[str]:
    """Integrity-check one rank dir against its manifest without
    restoring anything (``checkpoint.py:372``): every declared array
    entry must exist and match its crc32, and ``aux.pkl`` must load.
    Returns the problems found (empty: clean); leaves written before
    the crc32 are reported as unverifiable."""
    d = _rank_dir(path, rank)
    mpath = os.path.join(d, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except Exception as e:
        return [f"{mpath}: unreadable manifest ({type(e).__name__}: {e})"]
    problems: list[str] = []
    apath = os.path.join(d, "aux.pkl")
    try:
        with open(apath, "rb") as f:
            pickle.load(f)
    except Exception as e:
        problems.append(f"{apath}: missing or unreadable "
                        f"({type(e).__name__}: {e})")
    zpath = os.path.join(d, "arrays.npz")
    unverifiable = 0
    try:
        npz_cm = np.load(zpath)
    except Exception as e:
        problems.append(f"{zpath}: missing or unreadable "
                        f"({type(e).__name__}: {e})")
        return problems
    with npz_cm as npz:
        have = set(npz.files)
        for name, entry in manifest.get("entries", {}).items():
            for i, meta in enumerate(entry["leaves"]):
                if meta["kind"] == "obj":
                    continue
                key = f"{name}.{i}"
                if key not in have:
                    problems.append(f"{zpath}: entry {key!r} declared by "
                                    f"the manifest is absent")
                    continue
                want = meta.get("crc32")
                if want is None:
                    unverifiable += 1
                    continue
                try:
                    raw = npz[key]
                except Exception as e:
                    problems.append(f"{zpath}: entry {key!r} unreadable "
                                    f"({type(e).__name__}: {e})")
                    continue
                got = zlib.crc32(np.ascontiguousarray(raw))
                if got != want:
                    problems.append(
                        f"{name!r} leaf {i} ({key}): crc32 {got:#010x} "
                        f"!= manifest {want:#010x} (bit rot or torn "
                        f"write)")
    if unverifiable:
        problems.append(f"{unverifiable} array leaf(s) predate the "
                        f"integrity manifest (no crc32 recorded) — "
                        f"unverifiable, not necessarily bad")
    return problems


def info(path: str, *, verify: bool = False) -> dict:
    """Which ranks and names a checkpoint directory holds
    (``checkpoint.py:440``); ``verify=True`` also crc-checks every
    rank's arrays and reports per rank ``integrity``: ``"ok"`` or the
    problems."""
    root = os.path.expanduser(path)
    out: dict = {"path": root, "ranks": {}}
    if not os.path.isdir(root):
        return out
    for entry in sorted(os.listdir(root)):
        # rank_<digits> only: skips the .tmp / .old staging dirs an
        # interrupted save leaves.
        if not re.fullmatch(r"rank_\d+", entry):
            continue
        mpath = os.path.join(root, entry, "manifest.json")
        if not os.path.exists(mpath):
            continue
        with open(mpath) as f:
            manifest = json.load(f)
        rank = int(entry.split("_", 1)[1])
        desc = {"world_size": manifest.get("world_size"),
                "names": sorted(manifest.get("entries", {}))}
        if verify:
            problems = verify_rank(root, rank)
            desc["integrity"] = problems if problems else "ok"
        out["ranks"][rank] = desc
    return out
