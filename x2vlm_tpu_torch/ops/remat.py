"""Per-block rematerialisation (gradient checkpointing), the port's
counterpart of the JAX package's ``nn.remat`` blocks under
``checkpoint_policy`` (x2vlm_tpu/ops/layers.py).

A block run through :func:`block_call` with remat on keeps only what its
policy names from the forward; the backward recomputes the rest from the
block's inputs (``torch.utils.checkpoint``, non-reentrant). The policy
names are the JAX package's:

- ``None`` / ``"full"`` and ``"nothing"``: save only the block's inputs;
- ``"dots"``: also the outputs of the weight matmuls (``aten.mm`` /
  ``aten.addmm``, what ``dense`` lowers to), so the backward recomputes
  the elementwise work, the norms and the attention kernels only;
- ``"dots_saveable"``: also the batched products (``aten.bmm``, the plain
  attention core's scores and weighted sums).

Every draw of the port comes from an explicit ``torch.Generator``, which
``checkpoint``'s ``preserve_rng_state`` does not cover. So the recompute
starts from the generator's state at the block's first forward (the same
dropout and drop-path masks, the same dropout multiplier of the tiny
kernel) and leaves the generator where it found it: whatever draws after
the recompute (the next microbatch's forward, a later block) draws what it
would without remat. The forward runs the same operations in the same
order either way, so remat changes neither the loss nor, on the CPU, a bit
of the gradients.

Remat applies in training mode with grad enabled; in eval and under
``no_grad`` (serving, the cached decodes) a block runs plainly.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, FrozenSet, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn,
)

__all__ = ["POLICIES", "checkpoint_policy", "block_call", "rematerialised"]

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
# the saved operations of each named policy; None: only the block's inputs
POLICIES = {"full": None, "nothing": None, "dots": _DOTS,
            "dots_saveable": _DOTS | {_aten.bmm.default, _aten.baddbmm.default}}


def checkpoint_policy(name: Optional[str]) -> Optional[FrozenSet]:
    """The operations whose outputs the policy ``name`` saves (None: none,
    the block's inputs only). Raises on a name the JAX package does not
    know."""
    if name is None:
        return None
    if name not in POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of "
                         f"{sorted(k for k in POLICIES if k != 'full')} or 'full'")
    return POLICIES[name]


def _context_fn(saved: Optional[FrozenSet]):
    """Checkpoint's ``context_fn``: selective checkpointing that saves the
    outputs of ``saved``, or none."""
    if saved is None:
        return noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def rematerialised(block: Callable, *args, generator: Optional[torch.Generator] = None,
                   policy: Optional[str] = None, **kwargs):
    """``block(*args, generator=generator, **kwargs)`` under checkpoint with
    ``policy``; the recompute replays ``generator`` from its state now and
    restores the state it finds. Counts the call in
    ``rematerialised.calls`` by the block's class name."""
    rematerialised.calls[type(block).__name__] += 1
    start = None if generator is None else generator.get_state()
    runs = [0]

    def body(*a, **kw):
        runs[0] += 1
        if runs[0] == 1 or generator is None:
            return block(*a, generator=generator, **kw)
        found = generator.get_state()
        generator.set_state(start)
        try:
            return block(*a, generator=generator, **kw)
        finally:
            generator.set_state(found)

    # without an explicit generator the draws are the global RNG's, which
    # checkpoint itself stashes and restores
    return checkpoint(body, *args, use_reentrant=False,
                      context_fn=_context_fn(checkpoint_policy(policy)),
                      preserve_rng_state=generator is None, **kwargs)


rematerialised.calls = collections.Counter()


def block_call(block: torch.nn.Module, *args, remat: bool, policy: Optional[str] = None,
               generator: Optional[torch.Generator] = None, **kwargs):
    """``block`` on ``args``, rematerialised under ``policy`` when ``remat``
    is on, ``block`` is training and grad is enabled; else plainly."""
    if remat and block.training and torch.is_grad_enabled():
        return rematerialised(block, *args, generator=generator, policy=policy, **kwargs)
    return block(*args, generator=generator, **kwargs)
