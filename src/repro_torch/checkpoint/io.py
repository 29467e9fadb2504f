"""Checkpoints: parameter trees to ``.npz``, controller and loop state to
json (port of ``repro/checkpoint/io.py``).

The on-disk format is the reference's, so a checkpoint written by either
package resumes in the other:

* ``params.npz`` and ``opt_state.npz`` — one ``.npy`` member per leaf,
  named by its path (``SEP`` between keys, ``#i`` for list items);
* ``strategy_arrays.npz`` — the strategy's device state (``_arrays``: the
  qsgd_periodic anchor, DaSGD's in-flight correction and probe), removed
  when a save has none;
* ``meta.json`` — ``step``, ``controller`` (the strategy's adaptive state,
  Algorithm 2's p, C2 and cnt among it) and, with a clock, ``clock``.

The controller's adaptive state is training state: a restored run must
continue the same period schedule.  Saving writes each leaf as it is
fetched from the device, so the host holds one leaf of each archive at a
time, not the whole tree as the reference's ``np.savez(**flat)`` does;
the archive is the one ``np.savez`` writes for the same arrays (stored
members, zip64).  The archives are written, and read, side by side, one
thread each (the zip's CRC and the copies hold one core per archive); a
stored member is read straight into its array, a few members of an
archive at once, its CRC-32 checked as ``np.load``'s zip reader does.
Loading places each leaf on the card unless another device is asked for.
"""
from __future__ import annotations

import json
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Pytree = Any
SEP = "|"
READ_THREADS = 4        # members of one archive read at once


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, Any]:
    """Path -> leaf, leaves as they are (tensors, arrays or scalars)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}#{i}" if prefix else f"#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Pytree:
    """The tree of ``_flatten``'s paths; a node whose keys are all ``#i``
    is a list."""
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [rebuild(node[f"#{i}"]) for i in range(len(node))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write_npz(path: str, tree: Pytree) -> None:
    """``np.savez(path, **_flatten(tree))``, fetching and writing one leaf
    at a time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, leaf in _flatten(tree).items():
            arr = _host(leaf)
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            del arr


def _read_member(path: str, info: zipfile.ZipInfo,
                 device: torch.device) -> torch.Tensor:
    """One stored ``.npy`` member of the archive at ``path`` as a fresh
    contiguous tensor on ``device``: its bytes go straight from the file
    into a fresh array (one read, no copies through the zip reader, which
    took 2.65 times as long: ``scripts/ckpt_read_time.py``), and its
    CRC-32 is checked as ``np.load``'s zip reader checks it.  Both
    packages' writers store their members; a compressed one is refused."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: {info.filename} is compressed; "
                         f"checkpoints store their members")
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)                      # the local file header
        if head[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"{path}: bad header of {info.filename}")
        n_name, n_extra = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        start = f.tell()
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                                 if version == (1, 0) else
                                 np.lib.format.read_array_header_2_0(f))
        head_len = f.tell() - start
        f.seek(start)
        npy_head = f.read(head_len)
        arr = np.empty(shape, dtype, order="F" if fortran else "C")
        data = memoryview(arr.reshape(-1, order="A")).cast("B")
        if f.readinto(data) != data.nbytes or \
                head_len + data.nbytes != info.file_size:
            raise zipfile.BadZipFile(f"{path}: {info.filename} is short")
    if zlib.crc32(data, zlib.crc32(npy_head)) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    return torch.from_numpy(arr).to(device).contiguous()


def _read_npz(path: str, device: torch.device) -> Pytree:
    """Each member onto ``device`` as it is read, a few members side by
    side, a thread each (a read and its CRC hold one core).  Onto the
    card, the host holds at most ``READ_THREADS`` members of an archive
    at once."""
    with zipfile.ZipFile(path) as zf:
        infos = [i for i in zf.infolist() if i.filename.endswith(".npy")]
    with ThreadPoolExecutor(max_workers=READ_THREADS) as pool:
        leaves = list(pool.map(lambda i: _read_member(path, i, device),
                               infos))
    return _unflatten({i.filename[:-len(".npy")]: x
                       for i, x in zip(infos, leaves)})


def _side_by_side(jobs: Dict[str, Callable[[], Any]]) -> Dict[str, Any]:
    """Run each job in a thread of its own; their results by name (the
    first error raised, after every job has ended)."""
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
    return {k: f.result() for k, f in futures.items()}


def save_checkpoint(path: str, params: Pytree, *,
                    opt_state: Optional[Pytree] = None,
                    step: int = 0,
                    controller_state: Optional[Dict] = None,
                    clock_state: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    state = dict(controller_state or {})
    arrays = state.pop("_arrays", None)
    arr_path = os.path.join(path, "strategy_arrays.npz")
    trees = {"params.npz": params, "opt_state.npz": opt_state,
             "strategy_arrays.npz": arrays or None}
    _side_by_side({
        name: (lambda p=os.path.join(path, name), t=tree: _write_npz(p, t))
        for name, tree in trees.items() if tree is not None})
    if not arrays and os.path.exists(arr_path):
        os.remove(arr_path)            # don't resurrect a stale anchor
    meta = {"step": step, "controller": state}
    if clock_state is not None:
        # the telemetry clock's coordinates are training state: a
        # time-driven schedule (AdaComm's t0 blocks) resumes mid-block
        meta["clock"] = clock_state
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device: DeviceLike = None,
                    ) -> Tuple[Pytree, Optional[Pytree], Dict]:
    """(params, opt_state or None, meta) with every array on ``device``
    (the card unless ``"cpu"`` is passed); the strategy's arrays ride
    ``meta["controller"]["_arrays"]``.  To resume, load onto the host:
    ``TrainerEngine.load_state`` copies each leaf onto the card once."""
    device = resolve_device(device)
    names = [n for n in ("params.npz", "opt_state.npz",
                         "strategy_arrays.npz")
             if n == "params.npz" or os.path.exists(os.path.join(path, n))]
    trees = _side_by_side({
        n: (lambda p=os.path.join(path, n): _read_npz(p, device))
        for n in names})
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if "strategy_arrays.npz" in trees:
        meta.setdefault("controller", {})["_arrays"] = \
            trees["strategy_arrays.npz"]
    return trees["params.npz"], trees.get("opt_state.npz"), meta


def controller_state(ctrl) -> Dict:
    d = {"n_syncs": ctrl.n_syncs}
    d.update(ctrl.state_dict())
    return d


def restore_controller(ctrl, state: Dict) -> None:
    ctrl.load_state_dict(state)


def strategy_state(strategy) -> Dict:
    """Serializable adaptive state of a ``CommunicationStrategy`` (its
    controller's Algorithm 2 state among it); device state rides
    ``_arrays``."""
    d = {"strategy": strategy.name}
    d.update(strategy.state_dict())
    return d


def restore_strategy(strategy, state: Dict) -> None:
    """Restore ``strategy_state`` into a fresh strategy: the resumed run
    continues the identical sync schedule."""
    saved = state.get("strategy")
    if saved and saved != strategy.name:
        raise ValueError(
            f"checkpoint holds state for strategy '{saved}', "
            f"got '{strategy.name}'")
    strategy.load_state_dict(state)
