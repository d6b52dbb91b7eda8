"""Per-device execution locks for the port's traversal programs.

The port of ``repro.core.devlock``.  The reference keys its lock by a
mesh's device set: two collective programs dispatched concurrently onto
the same devices can deadlock in XLA's rendezvous.  The port runs its P
ranks as the leading axis of tensors on ONE device, so there is no
rendezvous to deadlock; what two engines on one card share is the
device's stream and memory, and a program's host-driven level loop reads
values back between launches.  Engines (the replicas of the serving
stack) that share a card therefore serialize their waves, which on one
card is also the only honest schedule: they time-slice the same silicon.
Engines on different devices take different locks and overlap freely.

The lock is keyed by the torch device, ``(type, index)``: ``"cuda"`` and
``"cuda:0"`` name the same card when the current device is 0.

Usage: hold the lock across dispatch AND the device-to-host copy of the
result (work left queued past the lock still occupies the device)::

    with device_lock(device):
        out = fn(*args)
        out = out.cpu()
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

_REGISTRY: Dict[Tuple[str, int], threading.RLock] = {}
_REGISTRY_LOCK = threading.Lock()


def _key(device) -> Tuple[str, int]:
    dev = torch.device(device)
    index = dev.index
    if index is None:
        index = torch.cuda.current_device() if dev.type == "cuda" else 0
    return dev.type, int(index)


def device_lock(device) -> threading.RLock:
    """The execution lock of ``device`` (a :class:`torch.device` or its
    name).  Engines on the same device share one re-entrant lock; distinct
    devices get independent locks."""
    key = _key(device)
    with _REGISTRY_LOCK:
        lock = _REGISTRY.get(key)
        if lock is None:
            lock = _REGISTRY[key] = threading.RLock()
        return lock
