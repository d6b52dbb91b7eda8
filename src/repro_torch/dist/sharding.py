"""Parameter descriptors, their initialization, and the mesh rules and
placement of the simulated devices (the port of ``repro.dist.sharding``).

Parameters, inputs and caches are declared as nested dicts of :class:`PD`:
shape, *logical* axis names ("embed", "heads", "ff", "vocab", "batch",
...), init law and an optional dtype override. The logical names are kept
so the trees equal the reference's.

The port's mesh is :class:`SimMesh`: named axes with sizes, as a
``jax.sharding.Mesh`` has them (``("data",)``, ``("data", "model")``,
``("pod", "data", "model")``, ``("stage", "data")``), its devices
simulated and numbered row-major over the axes, the order of
``jax.make_mesh``'s devices. ``SimMesh(P)`` is the one-axis ``data`` mesh
of P ranks. :func:`rules_for_mesh` routes the logical names onto the axes
as the reference does:

* ``batch``  -> the data-parallel axes (``data``, plus ``pod`` when present)
* ``heads`` / ``kv_heads`` / ``ff`` / ``vocab`` / ``experts`` / ``d_inner``
  -> the tensor-parallel ``model`` axis
* ``embed``  -> the data axes again when FSDP is on (ZeRO-3), else replicated
* anything else (``layers``, ``None``) -> replicated

:func:`spec_for` / :func:`tree_pspecs` apply the rules with the
reference's divisibility fallback (a dimension that does not divide over
its axes stays replicated). A spec is a plain tuple mirroring
``PartitionSpec``'s entries: ``None``, an axis name, or a tuple of axis
names, trailing ``None``s dropped. :func:`tree_structs` gives the
allocation-free :class:`ShardStruct` of each leaf (the counterpart of a
sharded ``ShapeDtypeStruct``); :func:`place` is ``device_put`` with a
``NamedSharding``: the per-device shards of a global tensor stacked on a
leading ``[n_devices, ...]`` axis, shard ``i`` being the reference's
``addressable_shards[i]``; :func:`gather` is its inverse.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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


# logical-name -> rule-field routing
_BATCH_LOGICAL = ("batch",)
_MODEL_LOGICAL = ("heads", "kv_heads", "ff", "vocab", "experts", "d_inner")
_FSDP_LOGICAL = ("embed",)

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class SimMesh:
    """Simulated devices on named axes: ``SimMesh((2, 4), ("data",
    "model"))``; ``SimMesh(P)`` is P ranks on one ``"data"`` axis. Device
    ``i`` sits at the row-major coordinates of ``i`` over ``sizes``."""

    sizes: Union[int, Tuple[int, ...]]
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        sizes = (self.sizes,) if isinstance(self.sizes, int) else tuple(self.sizes)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh sizes {sizes} do not name axes {names}")
        if any(int(n) < 1 for n in sizes):
            raise ValueError(f"mesh sizes {sizes} must be positive")
        object.__setattr__(self, "sizes", tuple(int(n) for n in sizes))
        object.__setattr__(self, "axis_names", names)

    @property
    def ranks(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def coords(self, ranks) -> np.ndarray:
        """int64[len(ranks), n_axes]: each device's coordinate on every axis."""
        return np.stack(np.unravel_index(np.asarray(ranks, dtype=np.int64), self.sizes),
                        axis=-1)

    def axis_stride(self, axis: str) -> int:
        """How far apart two devices one step along ``axis`` are numbered."""
        return math.prod(self.sizes[self.axis_names.index(axis) + 1:])

    def group_index(self, ranks, axes: Sequence[str]) -> np.ndarray:
        """Each device's row-major index over ``axes``: its position in its
        group of devices that differ only on those axes."""
        c = self.coords(ranks)
        out = np.zeros(len(c), dtype=np.int64)
        for a in axes:
            out = out * self.shape[a] + c[:, self.axis_names.index(a)]
        return out


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Physical axes for each logical role (empty tuple = replicated)."""

    batch: Tuple[str, ...] = ()
    model: Tuple[str, ...] = ()
    fsdp: Tuple[str, ...] = ()

    def axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical in _BATCH_LOGICAL:
            return self.batch
        if logical in _MODEL_LOGICAL:
            return self.model
        if logical in _FSDP_LOGICAL:
            return self.fsdp
        return ()


def rules_for_mesh(mesh: SimMesh, fsdp: bool = False) -> MeshRules:
    """``data`` / ``pod`` / ``batch`` axes carry the batch; a ``model`` axis
    carries tensor parallelism; with ``fsdp`` the embed dimension is
    additionally sharded over the batch axes (ZeRO-3), which the butterfly
    step refuses."""
    names = tuple(mesh.axis_names)
    batch = tuple(a for a in names if a in ("pod", "data", "batch"))
    model = tuple(a for a in names if a == "model")
    return MeshRules(batch=batch, model=model, fsdp=batch if fsdp else ())


def _axes_size(mesh: SimMesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def spec_for(pd: PD, rules: MeshRules, mesh: SimMesh) -> Spec:
    """The spec of one PD, with the divisibility fallback."""
    entries = []
    for dim, logical in zip(pd.shape, pd.logical):
        axes = rules.axes_for(logical)
        if axes and dim % _axes_size(mesh, axes) == 0:
            entries.append(axes[0] if len(axes) == 1 else tuple(axes))
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()  # trailing Nones are implicit
    return tuple(entries)


def tree_pspecs(defs, rules: MeshRules, mesh: SimMesh):
    """PD tree -> spec tree (same structure)."""
    return tree_map(lambda pd: spec_for(pd, rules, mesh), defs)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Sequence[int], spec: Spec, mesh: SimMesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` tensor laid out by ``spec``."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    used = [a for entry in spec for a in _entry_axes(entry)]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} maps an axis to more than one dimension")
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _axes_size(mesh, _entry_axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split {n} ways ({spec})")
        out[i] //= n
    return tuple(out)


def held_block(pd: PD, rules: MeshRules, mesh: SimMesh
               ) -> Tuple[Tuple[int, ...], Optional[int]]:
    """(one device's block of ``pd`` by :func:`spec_for`, the dimension split
    over ``rules.fsdp``, FSDP's data axes, or None): where the port's FSDP
    cuts a parameter leaf, the divisibility fallback applied."""
    spec = spec_for(pd, rules, mesh)
    fsdp = next((i for i, entry in enumerate(spec)
                 if rules.fsdp and _entry_axes(entry) == tuple(rules.fsdp)), None)
    return shard_shape(pd.shape, spec, mesh), fsdp


@dataclasses.dataclass(frozen=True)
class ShardStruct:
    """A leaf's global shape, dtype and spec, and one device's block of it:
    what a sharded ``ShapeDtypeStruct`` says, without allocating."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec
    shard_shape: Tuple[int, ...]


def tree_structs(defs, default_dtype, rules: MeshRules, mesh: SimMesh):
    """PD tree -> :class:`ShardStruct` tree (the dry run's building block)."""

    def leaf(pd: PD) -> ShardStruct:
        spec = spec_for(pd, rules, mesh)
        return ShardStruct(tuple(pd.shape), resolve_dtype(pd, default_dtype), spec,
                           shard_shape(pd.shape, spec, mesh))

    return tree_map(leaf, defs)


def _block(shape, spec: Spec, mesh: SimMesh, coords) -> Tuple[slice, ...]:
    """Device ``coords``' block of a ``shape`` tensor: along a dimension
    sharded over axes ``(a, b, ...)`` the block index is the row-major
    index of the device's coordinates on those axes."""
    out = []
    for i, n in enumerate(shape):
        axes = _entry_axes(spec[i]) if i < len(spec) else ()
        k, parts = 0, 1
        for a in axes:
            k = k * mesh.shape[a] + int(coords[mesh.axis_names.index(a)])
            parts *= mesh.shape[a]
        size = n // parts
        out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def place(x: torch.Tensor, spec: Spec, mesh: SimMesh) -> torch.Tensor:
    """``device_put(x, NamedSharding(mesh, spec))`` on simulated devices:
    ``[mesh.ranks, *shard_shape]``, device ``i``'s block at ``[i]`` (a
    replicated dimension is copied to every device), on ``x``'s device."""
    shard_shape(x.shape, spec, mesh)  # refuses a spec that does not divide
    coords = mesh.coords(range(mesh.ranks))
    return torch.stack([x[_block(x.shape, spec, mesh, c)] for c in coords])


def gather(shards: torch.Tensor, spec: Spec, mesh: SimMesh) -> torch.Tensor:
    """The inverse of :func:`place`: the global tensor from its stacked
    per-device blocks (a replicated block is taken from the first device
    that holds it)."""
    if shards.shape[0] != mesh.ranks:
        raise ValueError(f"{shards.shape[0]} shards for a mesh of {mesh.ranks} devices")
    shape = list(shards.shape[1:])
    for i, entry in enumerate(spec):
        shape[i] *= _axes_size(mesh, _entry_axes(entry))
    out = shards.new_empty(shape)
    seen = set()
    for i, c in enumerate(mesh.coords(range(mesh.ranks))):
        blk = _block(shape, spec, mesh, c)
        key = tuple((s.start, s.stop) for s in blk)
        if key not in seen:
            seen.add(key)
            out[blk] = shards[i]
    return out


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
    from repro_torch.core.bfs import resolve_device  # core imports this module

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
