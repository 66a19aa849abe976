"""The trainers' optimizer: optax's chain(scale_by_adam(b1, b2),
scale_by_learning_rate(lr / (1 + decay * t))) in PyTorch, and the
parameter-tree helpers the trainers share.

torch.optim.Adam folds the bias corrections in another order and a
LambdaLR steps on another clock, so neither is used. Per step, as optax
computes it (every operation in float32):
  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  n = count + 1
  update = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
  p += -(lr / (1 + decay * sched_count)) * update;  sched_count += 1
The schedule reads its own count before it is incremented, so the first
step takes lr. The state holds optax's four leaf groups in its order
(adam count, mu, nu, schedule count): state_leaves / state_from_leaves
give the leaf list a training checkpoint stores (utils/checkpoint.py).

The two counts are 0-d int32 tensors on the parameters' device, as
optax's are arrays: the bias corrections and the step size are computed
there, so an update reads nothing from the host and a step captured as
a CUDA graph (utils/graphs.py) replays with the counts it is given. The
eager call and the replay run the same operations, so they give the same
bits.
"""
import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tree = Dict[str, Any]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of nested dicts in JAX's order: keys sorted at every
    level, depth first."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(template: Tree, leaves) -> Tree:
    """The nesting of template with its leaves replaced, in tree_leaves
    order. Every dict keeps the template's order of keys, so that a
    step's output has its input's structure (one graph per run,
    utils/graphs.signature)."""
    it = iter(leaves)

    def build(node):
        out = dict.fromkeys(node)
        for k in sorted(node):
            out[k] = build(node[k]) if isinstance(node[k], dict) else next(it)
        return out

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


def value_and_grad(fn: Callable, params: Tree):
    """((value, aux), grads) of fn(params) -> (scalar value, aux): the
    leaves are detached copies that require grad, so params is left as it
    was (jax.value_and_grad(fn, has_aux=True))."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    value, aux = fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (value.detach(), aux), tree_unflatten(params, grads)


@dataclasses.dataclass(frozen=True)
class ScheduledAdam:
    lr: float = 1e-3
    decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Tree) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa
        count = lambda: torch.zeros((), dtype=torch.int32,  # noqa: E731
                                    device=tree_leaves(params)[0].device)
        return {"count": count(), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params), "sched_count": count()}

    def step_size(self, sched_count: torch.Tensor) -> torch.Tensor:
        """-lr / (1 + decay * t) in float32 on t's device, t the
        schedule's count (a true division, as optax's: `lr / x` of a
        tensor x multiplies by its reciprocal)."""
        t = sched_count.to(torch.float32)
        return -(t.new_full((), self.lr) / (1.0 + self.decay * t))

    def update(self, grads: Tree, state: Dict[str, Any]):
        """(updates, new state) for gradients grads (no parameter is
        touched)."""
        b1, b2 = self.b1, self.b2
        n = state["count"] + 1
        bc1 = 1.0 - torch.pow(b1, n.to(torch.float32))
        bc2 = 1.0 - torch.pow(b2, n.to(torch.float32))
        step = self.step_size(state["sched_count"])

        def moments(g, m, v):
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * (g * g) + b2 * v
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            return m, v, step * upd

        out = [moments(g, m, v) for g, m, v in zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]))]
        new_state = {"count": n,
                     "mu": tree_unflatten(grads, [o[0] for o in out]),
                     "nu": tree_unflatten(grads, [o[1] for o in out]),
                     "sched_count": state["sched_count"] + 1}
        return tree_unflatten(grads, [o[2] for o in out]), new_state

    @torch.no_grad()
    def apply(self, params: Tree, grads: Tree, state: Dict[str, Any]):
        """(params + updates, new state) for gradients grads."""
        updates, state = self.update(grads, state)
        return tree_map(lambda p, u: p + u, params, updates), state


def state_leaves(state: Dict[str, Any]) -> List[np.ndarray]:
    """The optimizer state as optax's flat leaf list: the adam count
    (int32 scalar), every mu leaf, every nu leaf, the schedule's count."""
    arr = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return ([arr(state["count"]).astype(np.int32)]
            + [arr(t) for t in tree_leaves(state["mu"])]
            + [arr(t) for t in tree_leaves(state["nu"])]
            + [arr(state["sched_count"]).astype(np.int32)])


def state_from_leaves(leaves, params: Tree) -> Dict[str, Any]:
    """The inverse of state_leaves, the moments shaped like params' leaves
    and on their device."""
    ps = tree_leaves(params)
    if len(leaves) != 2 * len(ps) + 2:
        raise ValueError(f"optimizer mismatch: {len(leaves)} leaves for "
                         f"{len(ps)} parameters (want {2 * len(ps) + 2})")
    n = len(ps)

    def moments(arrs):
        return tree_unflatten(params, [
            torch.as_tensor(np.asarray(a, np.float32).reshape(p.shape),
                            device=p.device) for a, p in zip(arrs, ps)])

    def count(a):
        return torch.as_tensor(np.asarray(a, np.int32).reshape(()),
                               device=tree_leaves(params)[0].device)

    return {"count": count(leaves[0]),
            "mu": moments(leaves[1:n + 1]),
            "nu": moments(leaves[n + 1:2 * n + 1]),
            "sched_count": count(leaves[-1])}
