"""The port's profiler spans: named ``torch.profiler`` ranges around the
work of a training step, so that a profile of the step can be summed by
what ran inside each.

Three kinds, all plain profiler ranges, on the clock of the profiler's
device events (a kernel is tied to the range around the host call that
launched it):

* :data:`OP_FAMILIES`: what a step's time is summed by beside the
  analytical ledger's families (:func:`op_family`); what runs in none of
  them is elementwise work.
* :data:`GEMM_PARTS`, nested inside a ``gemm`` range and never in place of
  it: ``int8_mm`` around each int8 product (``kernels.int8_gemm``),
  ``q8`` around each quantization (amax with its quantize) and each
  dequantization, ``expert_gemm`` around each MoE expert product,
  ``mla_proj`` around latent attention's projections (``q_proj``,
  ``kv_a_proj_with_mqa``, ``kv_b_proj``) and ``shared_expert`` around the
  shared experts' two products.
* :data:`DISPATCH_PARTS`, nested inside a ``moe_dispatch`` range: ``route``
  around a sigmoid-routed layer's float32 router product, its route
  kernel and its index of held experts.
* :data:`PHASES` of ``make_fused_adam``'s step: ``step`` around the whole
  call, ``forward`` around the loss and ``backward`` around
  ``torch.autograd.grad``; the optimizer phase is the ``optimizer`` family.

With no profiler running, :func:`span` returns one shared context that
does nothing: it costs a function call and a check of
``torch.autograd._profiler_enabled()``, and never enters
``record_function``. A CUDA graph capture records nothing of a span.

This module imports nothing of the port.
"""

from __future__ import annotations

import contextlib

import torch

OP_FAMILIES = ("gemm", "attention", "norm", "cross_entropy", "optimizer", "moe_dispatch")
GEMM_PARTS = ("int8_mm", "q8", "expert_gemm", "mla_proj", "shared_expert")
DISPATCH_PARTS = ("route",)
PHASES = ("step", "forward", "backward")
SPANS = OP_FAMILIES + GEMM_PARTS + DISPATCH_PARTS + PHASES

_OFF = contextlib.nullcontext()


def span(name: str):
    """The profiler range ``name`` (one of :data:`SPANS`) while a profiler
    runs; a shared no-op context otherwise."""
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r} (known: {SPANS})")
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def op_family(name: str):
    """The span that marks what runs inside it as one of
    :data:`OP_FAMILIES`, so a profile of a step can be summed by family
    beside the analytical ledger's."""
    if name not in OP_FAMILIES:
        raise ValueError(f"unknown op family {name!r} (known: {OP_FAMILIES})")
    return span(name)
