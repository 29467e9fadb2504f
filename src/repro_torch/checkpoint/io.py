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
fetched from the device, so the host holds one leaf at a time, not the
whole tree as the reference's ``np.savez(**flat)`` does; the archive is
the one ``np.savez`` writes for the same arrays (stored members, zip64).
Loading places each leaf on the card unless another device is asked for.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Pytree = Any
SEP = "|"


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


def _read_npz(path: str, device: torch.device) -> Pytree:
    """Each member onto ``device`` as it is read: a fresh contiguous
    tensor per leaf."""
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            flat[k] = torch.from_numpy(z[k]).to(device).contiguous()
    return _unflatten(flat)


def save_checkpoint(path: str, params: Pytree, *,
                    opt_state: Optional[Pytree] = None,
                    step: int = 0,
                    controller_state: Optional[Dict] = None,
                    clock_state: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    _write_npz(os.path.join(path, "params.npz"), params)
    if opt_state is not None:
        _write_npz(os.path.join(path, "opt_state.npz"), opt_state)
    state = dict(controller_state or {})
    arrays = state.pop("_arrays", None)
    arr_path = os.path.join(path, "strategy_arrays.npz")
    if arrays:
        _write_npz(arr_path, arrays)
    elif os.path.exists(arr_path):
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
    params = _read_npz(os.path.join(path, "params.npz"), device)
    opt_state = None
    opt_path = os.path.join(path, "opt_state.npz")
    if os.path.exists(opt_path):
        opt_state = _read_npz(opt_path, device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arr_path = os.path.join(path, "strategy_arrays.npz")
    if os.path.exists(arr_path):
        meta.setdefault("controller", {})["_arrays"] = _read_npz(arr_path,
                                                                 device)
    return params, opt_state, meta


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
