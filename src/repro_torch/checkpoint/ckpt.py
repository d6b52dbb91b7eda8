"""Checkpointing: the reference's on-disk layout, async save, atomic writes.

The port of ``repro.checkpoint.ckpt``, writing what the reference writes,
so a checkpoint crosses between the packages in both directions:

* **Layout**: one ``arrays.npz`` of full logical arrays keyed
  ``<tree>/<path>``: the model as the reference's parameter tree
  (``params/groups/blocks/attn/wq`` with the layer axes stacked, through
  ``api.to_reference``), the optimizer state by its paths
  (``opt_state/m/...``, ``opt_state/v/...``, ``opt_state/count``, or
  Adafactor's ``opt_state/f/.../vr|vc|v``), plus ``manifest.json`` (step,
  sorted keys, meta). A bfloat16 leaf is written as its 16-bit pattern in a
  ``|V2`` array, the bytes and dtype the reference's ``np.savez`` of an
  ``ml_dtypes.bfloat16`` leaf writes, and read back as bfloat16.
* **Async save**: arrays are copied to the host (blocking), then a writer
  thread serializes them; the train loop stalls only for the copy.
* **Atomicity**: writes go to ``<dir>.tmp`` then ``os.replace``, so a
  crash mid-save never corrupts the latest checkpoint.
* **Elastic reshard**: ``restore(mesh=, pspecs=)`` places the stored full
  arrays onto any :class:`~repro_torch.dist.sharding.SimMesh`, whatever
  mesh wrote them (a checkpoint holds no mesh). A model sharded over the
  model axis saves its gathered tree (``api.to_reference``), the file the
  unsharded model writes, and a sharded template restores its blocks
  (``optim.local_state`` / ``optim.from_placed`` for the state).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
from torch import nn

from repro_torch.core.bfs import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import sorted_leaves, tree_get, tree_set
from repro_torch.models import api


def _flatten(name: str, tree) -> Dict[str, np.ndarray]:
    """``<name>/<path>`` -> host array, for a model or a nested dict."""
    if isinstance(tree, nn.Module):
        tree = api.to_reference(tree)
    return {"/".join((name,) + path): (leaf if isinstance(leaf, np.ndarray)
                                       else api.to_numpy(leaf))
            for path, leaf in sorted_leaves(tree)}


def save(path: str, step: int, trees: Dict[str, Any], *, async_: bool = False,
         meta: Optional[Dict] = None) -> Optional[threading.Thread]:
    """trees: named models or nested dicts of tensors, e.g. ``{"params":
    model, "opt_state": state}``. Returns the writer thread when
    ``async_``."""
    host: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        host.update(_flatten(name, tree))  # device -> host (blocking)

    def write():
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {"step": step, "keys": sorted(host.keys()), "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(path):
            os.replace(os.path.join(tmp, "arrays.npz"), os.path.join(path, "arrays.npz"))
            os.replace(os.path.join(tmp, "manifest.json"), os.path.join(path, "manifest.json"))
            os.rmdir(tmp)
        else:
            os.replace(tmp, path)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(path: str) -> Optional[int]:
    man = os.path.join(path, "manifest.json")
    if not os.path.exists(man):
        return None
    with open(man) as f:
        return json.load(f)["step"]


def restore(path: str, templates: Dict[str, Any], *, mesh: Optional[shd.SimMesh] = None,
            pspecs: Optional[Dict[str, Any]] = None, device="cuda"
            ) -> Tuple[int, Dict[str, Any]]:
    """Restore named trees; ``templates`` give their structure. A model
    template is filled in place on its own device; any other template (a
    nested dict of tensors, arrays or ``PD``s) gives a new tree of tensors
    on ``device`` (the card by default; raises when there is none).

    With ``mesh`` and ``pspecs`` (named trees of specs, keyed by the
    reference's paths), each named tree in ``pspecs`` comes back placed:
    every leaf the ``[mesh.ranks, *shard]`` per-device shards of the stored
    full array (:func:`~repro_torch.dist.sharding.place`), on ``device``.
    A model template is still filled in place, from the full arrays, after
    every leaf has been read and placed; its entry is then its shard tree."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, template in templates.items():
            specs = pspecs.get(name) if mesh is not None and pspecs is not None else None
            if isinstance(template, nn.Module):
                paths = [p for p, _, _ in api.param_leaves(template)]
            else:
                paths = [p for p, _ in sorted_leaves(template)]
            arrays = {p: data["/".join((name,) + p)] for p in paths}
            placed = None
            if specs is not None:
                placed = _unflatten({p: shd.place(api.from_numpy(a).to(dev), tree_get(specs, p),
                                                  mesh) for p, a in arrays.items()})
            if isinstance(template, nn.Module):
                api.load_reference(template, _unflatten(arrays))
                out[name] = template if placed is None else placed
            elif placed is not None:
                out[name] = placed
            else:
                out[name] = _unflatten({p: api.from_numpy(a).to(dev) for p, a in arrays.items()})
    return manifest["step"], out


def _unflatten(leaves: Dict[Tuple[str, ...], Any]) -> Dict:
    tree: Dict = {}
    for p, v in leaves.items():
        tree_set(tree, p, v)
    return tree
