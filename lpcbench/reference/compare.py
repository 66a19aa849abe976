"""Trees of tensors (nested dicts): rows taken, rows stacked, and two
states compared leaf by leaf."""
from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]


def leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v))
    return out


def rows(tree: Tree, idx) -> Tree:
    """Clones of rows idx of every leaf."""
    if isinstance(tree, dict):
        return {k: rows(v, idx) for k, v in tree.items()}
    return tree[idx].clone()


def cat(trees: List[Tree]) -> Tree:
    """The trees' leaves stacked along their first axis."""
    if isinstance(trees[0], dict):
        return {k: cat([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees)


def state_gaps(ref: Tree, prog: Tree) -> Tuple[torch.Tensor, int, str]:
    """Per row, the widest gap of a floating-point leaf between the
    reference's state and the program's, measured against the larger of 1
    and the reference leaf's largest magnitude; the rows in which an
    integer or boolean leaf differs; and the leaf of the widest gap."""
    gaps, bad, worst, top = None, None, "", -1.0
    p = dict(leaves(prog))
    for name, r in leaves(ref):
        q = p[name]
        if r.is_floating_point():
            if not r.numel():
                continue
            scale = max(1.0, float(r.abs().max()))
            d = ((r - q.to(r.dtype)).abs().reshape(r.shape[0], -1)
                 .max(-1).values / scale)
            if float(d.max()) > top:
                worst, top = name, float(d.max())
            gaps = d if gaps is None else torch.maximum(gaps, d)
        else:
            d = (r != q.to(r.dtype)).reshape(r.shape[0], -1).any(-1)
            bad = d if bad is None else bad | d
    return gaps, 0 if bad is None else int(bad.sum()), worst


def rows_differ(a: Tree, b: Tree) -> int:
    """Rows in which any leaf of b differs from a's."""
    bad = None
    q = dict(leaves(b))
    for name, v in leaves(a):
        d = (v != q[name].to(v.dtype)).reshape(v.shape[0], -1).any(-1)
        bad = d if bad is None else bad | d
    return int(bad.sum())
