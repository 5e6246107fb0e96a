"""The numbers that decide ``correct``, computed from the program's outputs
and the reference's.

Norms are compared leaf by leaf, as gaps of norms (never as the norm of a
difference), each against the reference's norm of that leaf or of the
median leaf, whichever is larger; the worst leaf is the number. Leaves
whose reference gradient is under a thousandth of the median leaf's (a
key's bias under softmax) move under Adam by round-off alone and are left
out of every leaf comparison.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

__all__ = ["rounding_leaves", "worst_leaf_gap", "worst_rel_gap", "median_leaf_gap",
           "median_rel_gap", "row_gaps"]

ROUNDING = 1e-3


def rounding_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad_norms.values())
    return sorted(n for n, v in ref_grad_norms.items() if v < ROUNDING * med)


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   skip: Iterable[str] = ()) -> Tuple[float, str]:
    """(max over leaves of |prog - ref| / max(ref, median of ref), the leaf)."""
    skip = set(skip)
    names = [n for n in ref if n not in skip]
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


def worst_rel_gap(prog: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """(max over keys of |prog - ref| / max(|ref|, 1e-6), the key)."""
    worst, at = 0.0, ""
    for k, r in ref.items():
        g = abs(prog[k] - r) / max(abs(r), 1e-6)
        if g > worst:
            worst, at = g, k
    return worst, at


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    skip: Iterable[str] = ()) -> Tuple[float, str]:
    """(the median over leaves of the gap :func:`worst_leaf_gap` takes the
    worst of, "median leaf")."""
    skip = set(skip)
    names = [n for n in ref if n not in skip]
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                             for n in names), "median leaf"


def median_rel_gap(prog: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """(the median over keys of the gap :func:`worst_rel_gap` takes the
    worst of, "median")."""
    return statistics.median(abs(prog[k] - r) / max(abs(r), 1e-6)
                             for k, r in ref.items()), "median"


def row_gaps(prog: Dict, ref: Dict) -> List[Tuple[float, str]]:
    """(|prog row - ref row| / |ref row|, "<key> row <i>") of every row of
    every (rows, width) matrix in ``ref``, over the rows both sides have."""
    out = []
    for k, r in ref.items():
        n = min(r.shape[0], prog[k].shape[0])
        p, r = prog[k][:n].float(), r[:n].float()
        gap = (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
        out.extend((float(g), f"{k} row {i}") for i, g in enumerate(gap))
    return out
