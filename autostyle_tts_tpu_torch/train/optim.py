"""Optimizers with optax's numerics, written out in PyTorch.

The JAX package trains with optax; ``torch.optim`` differs from it in ways
that show at a 1e-6 parity (``AdamW``'s default decay is 1e-2, not 1e-4;
``clip_grad_norm_`` adds 1e-6 to the norm; schedules advance at other
points). This module computes what optax computes, in the same order of
f32 operations:

- ``clip_by_global_norm(max_norm)``: g unchanged when ‖g‖ < max_norm, else
  ``g / ‖g‖ * max_norm`` (‖g‖ over every leaf, no epsilon; inside
  ``sharded_norm`` the norm that context names);
- ``adamw(lr, b1, b2, eps, weight_decay)``: ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g² + b2 nu``, bias-corrected by ``1 - b**count`` after the
  count's increment, ``u = mu_hat / (sqrt(nu_hat) + eps)``, then
  ``u + weight_decay * p``, scaled by ``-lr(count)`` with the schedule's
  count read before its increment;
- ``cosine_decay_schedule`` and ``linear_schedule``;
- ``MultiSteps(opt, k)``: the running mean of k micro-gradients
  (``acc + (g - acc) / (n + 1)``) applied as one update on the k-th, zero
  updates on the others.

A transformation is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, both functional; ``value_and_grad`` and
``apply_optimizer`` are the two halves of every training step. Trees are
dicts and lists of tensors; ``apply_updates`` adds updates to params. The state layout (what
``utils/checkpoint.py`` saves): a ``chain`` is a list of its members'
states; ``clip_by_global_norm`` holds ``{}``; ``adamw`` holds ``{"count",
"mu", "nu", "sched_count"}`` (0-d int64 counts, moment trees shaped like
the params); ``MultiSteps`` holds ``{"mini_step", "gradient_step", "acc",
"inner"}``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable, Iterator, List, NamedTuple, Tuple, Union

import torch

from ..weights import tree_map

Schedule = Union[float, Callable[[int], float]]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """The inverse of ``tree_leaves`` over ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


_NORMS: List[Callable[[Any], torch.Tensor]] = []


def global_norm(tree: Any) -> torch.Tensor:
    """‖tree‖ over every leaf; inside ``sharded_norm(norm)``, ``norm(tree)``."""
    if _NORMS:
        return _NORMS[-1](tree)
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in tree_leaves(tree)))


@contextmanager
def sharded_norm(norm: Callable[[Any], torch.Tensor]) -> Iterator[None]:
    """Make ``norm`` the global norm of every tree (the clip's and the
    recorded ``grad_norm``) inside the block: a step whose trees are one
    rank's slices passes the norm of the whole trees across the ranks."""
    _NORMS.append(norm)
    try:
        yield
    finally:
        _NORMS.pop()


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _device(tree: Any):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(grads, state, params=None):
        g_norm = global_norm(grads)
        if bool(g_norm < max_norm):
            return grads, state
        return tree_map(lambda g: (g / g_norm.to(g.dtype)) * max_norm, grads), state

    return GradientTransformation(lambda params: {}, update)


def _lr(schedule: Schedule, count: int) -> float:
    return schedule(count) if callable(schedule) else schedule


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: scale_by_adam, add_decayed_weights, scale_by_learning_rate."""

    def init(params):
        dev = _device(params)
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"count": _count(dev), "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "sched_count": _count(dev)}

    def update(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count.float()
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count.float()
        u = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
        if weight_decay:
            u = tree_map(lambda x, p: x + weight_decay * p, u, params)
        step_size = -_lr(learning_rate, int(state["sched_count"]))
        u = tree_map(lambda x: x * step_size, u)
        return u, {"count": count, "mu": mu, "nu": nu, "sched_count": state["sched_count"] + 1}

    return GradientTransformation(init, update)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


class MultiSteps:
    """Gradient accumulation: ``every_k`` micro-gradients averaged (running
    mean), one inner update on the last of them, zero updates between."""

    def __init__(self, opt: GradientTransformation, every_k_schedule: int):
        self.opt, self.k = opt, int(every_k_schedule)

    def init(self, params):
        dev = _device(params)
        return {"mini_step": _count(dev), "gradient_step": _count(dev),
                "acc": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                "inner": self.opt.init(params)}

    def update(self, grads, state, params=None):
        n = int(state["mini_step"])
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state["acc"])
        if n + 1 < self.k:
            return (tree_map(torch.zeros_like, grads),
                    dict(state, mini_step=state["mini_step"] + 1, acc=acc))
        updates, inner = self.opt.update(acc, state["inner"], params)
        return updates, {"mini_step": torch.zeros_like(state["mini_step"]),
                         "gradient_step": state["gradient_step"] + 1,
                         "acc": tree_map(torch.zeros_like, acc), "inner": inner}


def value_and_grad(loss_fn: Callable, params, has_aux: bool = False):
    """(loss, aux, grads) of ``loss_fn(params)`` with respect to every leaf
    of ``params``; a leaf the loss does not reach gets a zero gradient, as
    in JAX."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        out = loss_fn(tree_unflatten(params, leaves))
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def apply_optimizer(step, optimizer: GradientTransformation, params, grads, opt_state):
    """One optimizer update; records the pre-clip gradient norm on ``step``."""
    with torch.no_grad():
        step.grad_norm = global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state


def detached(tree):
    """The tree's tensors detached from autograd (no copy)."""
    return tree_unflatten(tree, [t.detach() for t in tree_leaves(tree)])


def default_optimizer(lr: float = 1e-4, total_steps: int = 10000) -> GradientTransformation:
    """The acoustic stages' optimizer: clip to global norm 1, AdamW (decay
    1e-4) on a cosine decay over ``total_steps``."""
    return chain(clip_by_global_norm(1.0), adamw(cosine_decay_schedule(lr, max(total_steps, 1))))
