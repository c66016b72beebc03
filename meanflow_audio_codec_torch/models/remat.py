"""Rematerialisation: recompute a function's activations in the backward pass
instead of keeping them.

Counterpart of the JAX package's ``nn.remat(ConvStage, policy=...)``
(``models/conv_flow.py``, ``architecture_options.remat`` and
``remat_policy``) and ``jax.checkpoint`` of the loss
(``training/train_step.py``, ``tpu.remat``), on
``torch.utils.checkpoint(use_reentrant=False)``.

Policies. JAX's ``dots_saveable`` (and its alias ``checkpoint_dots``) keeps
the outputs of matrix products and convolutions and recomputes only the
elementwise chain between them, so that remat costs no extra matrix FLOPs.
The port gets the same effect without a dispatch mode: the stage checkpoints
each of its elementwise segments on its own (:func:`remat` of LN + FiLM, of
the block's LN and of GELU + GRN; ``models/conv_flow.py``), so a segment
keeps only its input, a product's output, and its intermediates are
recomputed (the FiLM's condition projection, a [B, 2C] product, is
recomputed with its segment). Unlike JAX, torch's products also keep their
inputs, the segments' outputs, for their weight gradients. Policy ``None``
and ``nothing_saveable`` recompute the stage whole, as JAX does. (PyTorch's
selective-checkpoint policy, ``create_selective_checkpoint_contexts``, would
map ``dots_saveable`` op by op, but runs every op of the stage through a
Python dispatch mode; PERF.md records why the port does not use it.)

``torch.utils.checkpoint`` cannot recompute a region whose inputs carry
forward-mode tangents: at backward time the dual level of the objective's
JVP has closed, so the recomputation saves other tensors than the forward
did, and the checkpoint refuses it. :func:`remat` therefore splits such
inputs into primal and tangent, checkpoints a function of both that rebuilds
the dual tensors inside (in the objective's dual level during the forward, in
a dual level of its own during the recomputation) and returns the output's
primal and tangent, and joins those into a dual tensor again. Gradients flow
through primal and tangent alike, so it serves the stop-gradient objectives
and grad-of-JVP. The state of ``ops.stage.differentiable_tangents`` at the
call is restored for the recomputation.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from meanflow_audio_codec_torch.ops import stage

#: the remat policies the configs name (``jax.checkpoint_policies``)
POLICIES = (None, "nothing_saveable", "dots_saveable", "checkpoint_dots")
#: the policies that keep the products' outputs: the stage checkpoints its
#: elementwise segments, not itself (see the module docstring)
SEGMENT_POLICIES = ("dots_saveable", "checkpoint_dots")


def check_policy(policy: str | None) -> None:
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of "
                         f"{[str(p) for p in POLICIES]}, got {policy!r}")


def _dual_level():
    """The dual level in force, or a new one (the recomputation runs after
    the objective's level has closed)."""
    if fwAD._current_level >= 0:
        return contextlib.nullcontext()
    return fwAD.dual_level()


def remat(fn, *args: torch.Tensor):
    """``fn(*args)`` (one tensor out) with its activations recomputed in the
    backward pass; plain ``fn(*args)`` when no gradient is being
    recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    unpacked = [fwAD.unpack_dual(a) for a in args]
    tangents = [u.tangent for u in unpacked]
    if all(t is None for t in tangents):
        return checkpoint(fn, *args, use_reentrant=False)
    n = len(args)
    differentiable = stage.tangents_differentiable()

    def run(*flat):
        primals, tans = flat[:n], flat[n:]
        with _dual_level(), stage.differentiable_tangents(differentiable):
            out = fn(*(p if t is None else fwAD.make_dual(p, t)
                       for p, t in zip(primals, tans)))
            out = fwAD.unpack_dual(out)
            return out.primal, out.tangent

    primal, tangent = checkpoint(run, *[u.primal for u in unpacked],
                                 *tangents, use_reentrant=False)
    if tangent is None:
        return primal
    return fwAD.make_dual(primal, tangent)
