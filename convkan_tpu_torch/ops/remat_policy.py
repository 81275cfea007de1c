"""Rematerialized blocks, port of ``convkan_tpu/ops/remat_policy.py`` and of
the ``nn.remat`` wrapping of the JAX models' blocks: a block's forward
saves nothing for the backward pass but its input, and runs again there.

``resolve_remat_policy`` takes the JAX package's policy names.  None, "",
"full" and "nothing" save nothing (the only policy ported).  The selective
policies ("except_basis", "dots", "offload_basis") raise
NotImplementedError: they are queued in ROADMAP.md.

``checkpoint_block`` runs a block under ``torch.utils.checkpoint`` (the
non-reentrant form) and adds the two things that JAX's ``nn.remat`` gives
and torch does not:

* the masks: torch restores only the default CPU and CUDA generators for
  the recompute, never an explicit ``torch.Generator``, from which the port
  draws every dropout and DropPath mask.  The generator's state at the
  block's entry is kept and set again for the recompute (so it draws the
  forward's masks), and the state the recompute found is set back after
  it (so later draws do not move);
* BatchNorm's running statistics move once per step: the block's buffers
  are kept before the recompute and set back after it, so what the
  recompute moved does not stay.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# the JAX package's selective policies, queued in ROADMAP.md
QUEUED = ("except_basis", "dots", "offload_basis")


def resolve_remat_policy(name):
    """None for the policies that save nothing (None, "", "full",
    "nothing"); NotImplementedError for the selective ones, ValueError for
    an unknown name."""
    if name in (None, "", "full", "nothing"):
        return None
    if name in QUEUED:
        raise NotImplementedError(f"remat_policy={name!r} is not ported; it "
                                  "is queued in ROADMAP.md (only 'full' is)")
    raise ValueError(f"unknown remat_policy {name!r}; pick one of "
                     "full | except_basis | dots | offload_basis")


def checkpoint_block(block, x, generator: torch.Generator = None):
    """``block(x, generator)``, rematerialized when autograd records (else a
    plain call): the backward pass runs the block again from x, with the
    generator's state of the forward's entry, and its buffers (BatchNorm's
    running statistics) as they were before it (module docs)."""
    if not torch.is_grad_enabled():
        return block(x, generator)
    entry = None if generator is None else generator.get_state()
    calls = [0]

    def run(inp):
        calls[0] += 1
        if calls[0] == 1:
            return block(inp, generator)
        found = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(entry)
        buffers = list(block.buffers())
        kept = [b.clone() for b in buffers]
        try:
            return block(inp, generator)
        finally:
            if generator is not None:
                generator.set_state(found)
            with torch.no_grad():
                for b, v in zip(buffers, kept):
                    b.copy_(v)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=True)
