"""Parameter descriptors, their initialization, and the mesh rules of the
simulated ranks (the port of ``repro.dist.sharding``).

Parameters, inputs and caches are declared as nested dicts of :class:`PD`:
shape, *logical* axis names ("embed", "heads", "ff", "vocab", "batch",
...), init law and an optional dtype override. The logical names are kept
so the trees equal the reference's.

The port's mesh is :class:`SimMesh`: one ``"data"`` axis of P simulated
ranks on one device (the reference's ``launch.mesh.make_host_mesh``), and
:func:`rules_for_mesh` derives :class:`MeshRules` from it as the
reference does: ``rules.batch`` names the axis a train step syncs its
gradients over, and ``fsdp`` is carried so that the butterfly step can
refuse it. The placement half (``spec_for``, ``tree_pspecs``,
``tree_structs``) needs more than one card and is not ported.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bfs import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class PD:
    """Parameter/input descriptor: shape + logical axes + init + dtype.

    ``logical[i]`` names dimension ``i``; ``init`` is one of ``zeros`` /
    ``ones`` / ``normal`` (fixed 0.02 std) / ``scaled`` (fan-in scaled);
    ``dtype`` overrides the tree-wide default when set (e.g. int32 tokens,
    float32 router logits).
    """

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "zeros"
    dtype: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SimMesh:
    """``ranks`` simulated ranks on one device, on one axis named ``"data"``."""

    ranks: int
    axis_names = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.ranks}


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Physical axes for each logical role (empty tuple = replicated)."""

    batch: Tuple[str, ...] = ()
    fsdp: Tuple[str, ...] = ()


def rules_for_mesh(mesh: SimMesh, fsdp: bool = False) -> MeshRules:
    """The mesh's axis carries the batch; with ``fsdp`` the embed dimension
    is additionally sharded over it (ZeRO-3), which the butterfly step
    refuses. The reference's ``model`` axis has no simulated counterpart."""
    batch = tuple(mesh.axis_names)
    return MeshRules(batch=batch, fsdp=batch if fsdp else ())


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves_with_path(tree, path: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) for every leaf of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    else:
        yield path, tree


def tree_get(tree: dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def sorted_leaves(tree: dict, path: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) in the reference's leaf order: sorted keys at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def keystr(path: Tuple[str, ...]) -> str:
    """``['a']['b']``: the form ``jax.tree_util.keystr`` gives a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def resolve_dtype(pd: PD, default) -> torch.dtype:
    name = pd.dtype if pd.dtype is not None else default
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def init_leaf(pd: PD, gen: torch.Generator, default_dtype) -> torch.Tensor:
    """One leaf by its law, drawn in float32 from ``gen`` on its device."""
    dtype = resolve_dtype(pd, default_dtype)
    dev = gen.device
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=dev)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=dev)
    if pd.init == "normal":
        std = 0.02
    elif pd.init == "scaled":
        # fan-in scaled: all leading dims feed the last (output) dim
        fan_in = max(1, int(np.prod(pd.shape[:-1]))) if len(pd.shape) >= 2 else 1
        std = float(fan_in) ** -0.5
    else:
        raise ValueError(f"unknown init {pd.init!r}")
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=dev)
    return (x.mul_(std)).to(dtype)


def leaf_generator(seed: int, path: Tuple[str, ...], device) -> torch.Generator:
    """The generator of one leaf: seeded from ``seed`` and ``crc32`` of its
    path, as the reference salts ``fold_in``, so a leaf's values do not
    depend on the order the tree is walked in."""
    salt = zlib.crc32(keystr(path).encode()) & 0x7FFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 31) | salt)
    return gen


def iter_init(defs, seed: int, default_dtype="float32", device="cuda") -> Iterator:
    """(path, tensor) for every leaf of a PD tree, one leaf at a time, on
    ``device`` (the card by default; raises when there is none)."""
    device = resolve_device(device)
    for path, pd in tree_leaves_with_path(defs):
        yield path, init_leaf(pd, leaf_generator(seed, path, device), default_dtype)


def tree_init(defs, seed: int, default_dtype="float32", device="cuda"):
    """Deterministic init of a PD tree: the same nested dict, of tensors, on
    ``device`` (the card by default; raises when there is none)."""
    out: dict = {}
    for path, leaf in iter_init(defs, seed, default_dtype, device):
        tree_set(out, path, leaf)
    return out
