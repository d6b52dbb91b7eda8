"""Explicit merge monoids for the butterfly exchange (DESIGN.md §14/§19).

The port of ``repro.core.monoid``.  The paper's phase-2 synchronization is
"merge my buffer with every partner's": the merge op only has to be
associative and commutative for the butterfly to be exact.  The SPARSE
changed-word wire format adds the idempotence/delta dichotomy:

* **remerge** (idempotent monoids, OR/MIN/MAX): each rank ships the full value of
  every word CHANGED since a shared reference; duplicate delivery of a word
  across butterfly rounds re-combines harmlessly because
  ``combine(x, x) == x``.
* **delta** (non-idempotent monoids, ADD): each rank ships its own
  contribution relative to the monoid IDENTITY.  The butterfly delivers
  each subcube partial exactly once per destination, so summing is exact,
  but only when the reference IS the identity.

A wrong ``idempotent`` flag silently corrupts the sparse path, so the flag
is validated at construction against the combine fn on sample words; a
contradiction raises :class:`MonoidContractError` with the counterexample.

Words are int32 tensors holding the reference's uint32 bit patterns (see
:mod:`repro_torch.core.frontier`), so every integer comparison goes through
:func:`umin` / :func:`umax` / :func:`ult`, which order int32 words as the
uint32 values they hold: a signed min would make the unreached sentinel
``0xFFFFFFFF`` (``-1`` as an int32) the smallest distance.

* ``OR_U32``  — reachability bitmaps (BFS / MS-BFS / k-core / triangles).
* ``MIN_U32`` — tentative distances and labels (SSSP, CC): identity
  ``0xFFFFFFFF``, the unreached sentinel, so sparse padding is free.
* ``MAX_U32`` — label propagation toward the largest label.
* ``ADD_F32`` / ``ADD_U32`` — path counts, rank mass, dependencies
  (betweenness centrality, PageRank); not idempotent, so the sparse path
  ships delta contributions only.  int32 addition wraps exactly as uint32
  addition does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = [
    "Monoid",
    "MonoidContractError",
    "SPARSE_REMERGE",
    "SPARSE_DELTA",
    "OR_U32",
    "MIN_U32",
    "MAX_U32",
    "ADD_F32",
    "ADD_U32",
    "by_name",
    "umin",
    "umax",
    "ult",
]

#: Sparse wire modes (the §19 dichotomy).
SPARSE_REMERGE = "remerge"  # idempotent: changed-vs-ref full values
SPARSE_DELTA = "delta"  # non-idempotent: contributions vs the identity

# XOR with the sign bit maps uint32 order onto int32 order (0 -> INT32_MIN,
# 0xFFFFFFFF -> INT32_MAX), and is its own inverse
_SIGN = -(1 << 31)


def _biased(x: torch.Tensor) -> bool:
    """Whether ``x`` holds uint32 words as int32 patterns (compare biased);
    floats and wider integers compare as they are."""
    return x.dtype == torch.int32


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum in the order of the values held: int32 words as
    uint32."""
    if _biased(a):
        return torch.minimum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN
    return torch.minimum(a, b)


def umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum in the order of the values held: int32 words as
    uint32."""
    if _biased(a):
        return torch.maximum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN
    return torch.maximum(a, b)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """``a < b`` in the order of the values held: int32 words as uint32."""
    if _biased(a):
        return (a ^ _SIGN) < (b ^ _SIGN)
    return a < b


class MonoidContractError(ValueError):
    """A monoid's declared contract contradicts its combine fn, or a sparse
    exchange was requested outside the idempotence/delta dichotomy.

    Structured fields: ``monoid`` (name), ``flag`` (the declared
    ``idempotent`` value, when the construction probe failed),
    ``counterexample`` (a sample word ``x`` with ``combine(x, x) != x``,
    as an unsigned int for integer monoids, or ``None``)."""

    def __init__(self, message, *, monoid, flag=None, counterexample=None):
        super().__init__(message)
        self.monoid = monoid
        self.flag = flag
        self.counterexample = counterexample


_SCATTERS = ("or", "add", "min", "max")


def _word(value):
    """An identity as the element its tensors store: a float, or the int32
    bit pattern of a uint32 word."""
    if isinstance(value, float):
        return value
    return int(np.uint32(value).view(np.int32))


def _probe_words(identity) -> torch.Tensor:
    """Sample words for the construction-time idempotence probe, typed by
    the identity: float monoids get float32 probes, integer monoids the
    uint32 words the frontier machinery exchanges (as int32 patterns)."""
    if isinstance(identity, float):
        return torch.tensor([0.0, 1.0, -2.5, 3.25, 1e-3, 7.0], dtype=torch.float32)
    words = np.array([0, 1, 7, 0x80000001, 0xFFFFFFFF, 0xDEADBEEF], dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32).copy())


def _show(x: torch.Tensor):
    """A probe word for an error message: unsigned for integer words."""
    return float(x) if x.is_floating_point() else int(x) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Monoid:
    """A commutative merge monoid the butterfly can reduce over.

    ``combine`` must be associative + commutative with ``identity`` as unit.
    ``scatter`` names the scatter of :meth:`scatter_into`: ``"or"`` (a true
    OR of each value into its word), ``"add"`` (duplicates add), ``"min"``
    or ``"max"`` (duplicates combine in the words' uint32 order).
    ``idempotent`` selects the sparse wire mode (see module docstring).
    Both are validated against ``combine`` on sample words at construction:
    a scatter of one sample into each word must equal ``combine``.
    """

    name: str
    identity: int | float
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    scatter: str  # "or" | "add" | "min" | "max"
    idempotent: bool

    def __post_init__(self):
        if self.scatter not in _SCATTERS:
            raise ValueError(f"monoid {self.name!r}: unknown scatter {self.scatter!r}")
        xs = _probe_words(self.identity)
        mismatch = torch.nonzero(self.combine(xs, xs) != xs).flatten()
        if self.idempotent and mismatch.numel():
            x = xs[mismatch[0]]
            raise MonoidContractError(
                f"monoid {self.name!r} declared idempotent=True but "
                f"combine(x, x) != x for x={_show(x)!r} -> "
                f"{_show(self.combine(x, x))!r}; an idempotence mislabel "
                f"silently corrupts the sparse changed-word path",
                monoid=self.name, flag=True, counterexample=_show(x),
            )
        if not self.idempotent and not mismatch.numel():
            raise MonoidContractError(
                f"monoid {self.name!r} declared idempotent=False but "
                f"combine(x, x) == x on every probe word; a conservative "
                f"mislabel forces delta-mode shipping where remerge is "
                f"legal — fix the flag",
                monoid=self.name, flag=False, counterexample=None,
            )
        # identity must be a unit (sparse pads rely on it being a no-op)
        bad = torch.nonzero(self.combine(xs, self.identity_like(xs)) != xs).flatten()
        if bad.numel():
            x = _show(xs[bad[0]])
            raise MonoidContractError(
                f"monoid {self.name!r}: identity {self.identity!r} is not "
                f"a unit — combine(x, e) != x for x={x!r}",
                monoid=self.name, counterexample=x,
            )
        # the scatter must combine as combine does (the sparse receive side)
        ys = xs.flip(0)
        got = self.scatter_into(xs, torch.arange(xs.numel()), ys)
        bad = torch.nonzero(got != self.combine(xs, ys)).flatten()
        if bad.numel():
            i = int(bad[0])
            raise MonoidContractError(
                f"monoid {self.name!r}: scatter {self.scatter!r} disagrees "
                f"with combine at x={_show(xs[i])!r}, y={_show(ys[i])!r}",
                monoid=self.name, counterexample=_show(xs[i]),
            )

    @property
    def sparse_mode(self) -> str:
        """Which sparse wire format is exact for this monoid:
        :data:`SPARSE_REMERGE` (idempotent) or :data:`SPARSE_DELTA`."""
        return SPARSE_REMERGE if self.idempotent else SPARSE_DELTA

    def check_sparse_ref(self, ref) -> None:
        """Enforce the idempotence/delta dichotomy for a sparse exchange:
        idempotent monoids may reference any replicated-consistent buffer;
        non-idempotent monoids may ONLY ship deltas vs the identity
        (``ref is None``).  Raises :class:`MonoidContractError`."""
        if not self.idempotent and ref is not None:
            raise MonoidContractError(
                f"sparse butterfly over non-idempotent monoid "
                f"{self.name!r} must ship DELTA contributions vs the "
                f"identity (ref=None); a changed-vs-ref remerge would "
                f"double-count the shared reference on every receive "
                f"(DESIGN.md §19 dichotomy)",
                monoid=self.name,
            )

    def identity_like(self, x: torch.Tensor) -> torch.Tensor:
        """The identity as a 0-d tensor of ``x``'s type and device."""
        return torch.full((), _word(self.identity), dtype=x.dtype, device=x.device)

    def full(self, shape, dtype, device=None) -> torch.Tensor:
        return torch.full(tuple(shape), _word(self.identity), dtype=dtype,
                          device=device)

    def scatter_into(self, buf: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
        """Combine ``vals[..., C]`` into ``buf[..., W]`` at ``idx[..., C]``
        along the last axis (leading axes shared); returns a new buffer.

        ``"add"`` adds duplicates together; ``"min"`` and ``"max"`` combine
        them, int32 words in their uint32 order (biased through a signed
        ``scatter_reduce``: torch has no unsigned one on the CPU).  ``"or"``
        ORs each value into its word: slots holding the identity (the pads
        of a compaction, which all sit at index 0) go to a spare word past
        the end that is then dropped, so a real word at index 0 is never
        overwritten by a pad.  The other slots must name distinct words, as
        one compaction's pairs do (the reference's scatter-max makes the
        same assumption); OR-ing the identity is a no-op, so no pad is
        lost."""
        idx = idx.long()
        vals = vals.to(buf.dtype)
        if self.scatter == "add":
            return buf.scatter_add(-1, idx, vals)
        if self.scatter in ("min", "max"):
            how = "amin" if self.scatter == "min" else "amax"
            if _biased(buf):
                out = (buf ^ _SIGN).scatter_reduce(-1, idx, vals ^ _SIGN, how)
                return out ^ _SIGN
            return buf.scatter_reduce(-1, idx, vals, how)
        w = buf.shape[-1]
        ext = torch.cat([buf, self.full((*buf.shape[:-1], 1), buf.dtype, buf.device)], -1)
        tgt = torch.where(vals == self.identity_like(vals), w, idx)
        return ext.scatter(-1, tgt, ext.gather(-1, tgt) | vals)[..., :w]


OR_U32 = Monoid("or", 0, torch.bitwise_or, "or", idempotent=True)
MIN_U32 = Monoid("min", 0xFFFFFFFF, umin, "min", idempotent=True)
MAX_U32 = Monoid("max", 0, umax, "max", idempotent=True)
ADD_F32 = Monoid("add", 0.0, torch.add, "add", idempotent=False)
ADD_U32 = Monoid("add_u32", 0, torch.add, "add", idempotent=False)

_REGISTRY = {m.name: m for m in (OR_U32, MIN_U32, MAX_U32, ADD_F32, ADD_U32)}


def by_name(name: str) -> Monoid:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown monoid {name!r}; expected one of {sorted(_REGISTRY)}"
        ) from None
