"""Validation harness: the predicted peak against one measured step, and
the collectives a multi-rank step really runs.

Port of the JAX package's ``calibration/validate.py``. Where the
reference reads XLA's compiled program, the port runs the step and
watches it:

* :func:`memory_report` is the counterpart of ``xla_memory_report``: one
  eager step of the matching reference model (``torchref.rows.make_row_step``:
  the Llama with math or flash attention, int8 linear layers or full-block
  recompute, or the MoE model) on the card, read from the caching
  allocator (``torch.cuda.max_memory_allocated``) where the reference
  reads XLA's buffer assignment. The step runs eagerly, where the bench
  loop times replays of a captured CUDA graph: a graph keeps its
  intermediates in a private memory pool sized at capture, which is not
  the eager allocator's peak. :func:`validate_memory` compares the
  analytical peak with it.
* :class:`CollectiveRecord` is the counterpart of the compiled HLO
  text: a context manager over a step
  that records every collective the step dispatches, the functional
  collectives DTensor issues (seen by a ``TorchDispatchMode``, as
  ``torch.distributed.tensor.debug.CommDebugMode`` sees them) and the
  direct calls of ``torchref/collectives.py`` (through its listeners).
  :func:`collective_bytes` and :func:`replica_groups` read it with the
  return shapes of ``hlo_collective_bytes`` and ``hlo_replica_groups``;
  :func:`group_structure` is a plain copy.

One difference in what the numbers mean: XLA's CPU backend upcasts bf16
to f32 in the HLO the reference reads (``tests/test_hlo_crosscheck.py``
divides by that factor); the record holds the bytes of the dtype the step
really moves.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from simumax_tpu_torch.core.errors import CardRequiredError
from simumax_tpu_torch.torchref import collectives as C
from simumax_tpu_torch.torchref.model import resolve_device
from simumax_tpu_torch.torchref.rows import make_row_step

# -- memory -------------------------------------------------------------------


def memory_report(model_config, batch_size: int = 1, seq_len: int = 2048,
                  layer_num: Optional[int] = None, remat: bool = False, kind: str = "dense",
                  device="cuda") -> Dict[str, float]:
    """One eager fwd+bwd+Adam step of the reference model of ``kind``
    (``torchref.rows``: "dense", "flash", "int8" or "moe") for this model
    config on the card, from random weights, with the four keys of
    ``xla_memory_report`` (bytes, counted from the allocator's state
    before the model was built):

    * ``argument_size_in_bytes``: params, Adam moments, step count and
      token ids before the step;
    * ``output_size_in_bytes``: what the step leaves allocated. The update
      is in place (as JAX with donated arguments), so the outputs are the
      argument buffers themselves plus the loss: this is not added to the
      peak;
    * ``temp_size_in_bytes``: the peak above the arguments;
    * ``peak_memory_in_bytes``: the step's ``max_memory_allocated``.

    Raises :class:`CardRequiredError` off the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise CardRequiredError(f"the memory report measures on the CUDA card, not on {dev}")
    torch.cuda.synchronize(dev)
    floor = torch.cuda.memory_allocated(dev)
    step = make_row_step(kind, model_config, seq_len, batch_size,
                         layer_num or model_config.layer_num, remat, device=dev)
    torch.cuda.synchronize(dev)
    args = torch.cuda.memory_allocated(dev) - floor
    torch.cuda.reset_peak_memory_stats(dev)
    loss = step()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - floor
    output = torch.cuda.memory_allocated(dev) - floor
    if not torch.isfinite(loss):
        raise RuntimeError(f"the memory report's step gave a non-finite loss ({float(loss)})")
    del step, loss
    torch.cuda.empty_cache()
    return {
        "argument_size_in_bytes": float(args),
        "output_size_in_bytes": float(output),
        "temp_size_in_bytes": float(peak - args),
        "peak_memory_in_bytes": float(peak),
    }


def reference_kind(perf) -> str:
    """The reference model that runs ``perf``'s single-card step, as a
    bench row kind (``torchref.rows``): "moe", "int8", "flash" or "dense"."""
    st = perf.strategy
    if st.world_size != 1:
        raise ValueError(f"memory validation compares one card, not world size "
                         f"{st.world_size}")
    if st.enable_recompute and st.recompute_granularity != "full_block":
        raise ValueError(f"the reference models recompute full blocks only, not "
                         f"{st.recompute_granularity!r}")
    if perf.model_config.model_type == "moe":
        return "moe"
    if st.fp8:
        return "int8"
    return "flash" if st.sdp_backend == "cuda" else "dense"


def validate_memory(perf, device="cuda") -> Dict[str, float]:
    """Compare ``perf``'s predicted peak (a single-card strategy, after
    ``run_estimate``) with :func:`memory_report` of the matching
    reference model. Returns the report's keys, ``predicted_peak_bytes``
    and ``ratio`` (predicted / measured peak)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise CardRequiredError(f"memory validation measures on the CUDA card, not on {dev}")
    kind = reference_kind(perf)
    st, mc = perf.strategy, perf.model_config
    report = memory_report(mc, st.micro_batch_size, st.seq_len, mc.layer_num,
                           st.enable_recompute, kind=kind, device=dev)
    predicted = perf.analysis_mem()["max_peak_bytes"]
    return {
        **report,
        "predicted_peak_bytes": predicted,
        "ratio": predicted / report["peak_memory_in_bytes"],
    }


# -- collectives --------------------------------------------------------------

#: the names of ``torchref.collectives``' ops as HLO's op families
_LEDGER_FAMILIES = {"all_gather": "all-gather", "psum_scatter": "reduce-scatter",
                    "psum": "all-reduce", "pmax": "all-reduce", "all_to_all": "all-to-all",
                    "ppermute": "collective-permute"}


def _funcol_families() -> Dict:
    """The functional collectives DTensor issues, by overload packet."""
    native = torch.ops._c10d_functional
    return {native.all_gather_into_tensor: "all-gather",
            native.reduce_scatter_tensor: "reduce-scatter",
            native.all_reduce: "all-reduce", native.all_to_all_single: "all-to-all"}


def _axis_groups(mesh, axis: str) -> List[List[int]]:
    """Every group of global ranks along a mesh axis, over the whole mesh."""
    grid = mesh.mesh
    dim = mesh.mesh_dim_names.index(axis)
    return grid.movedim(dim, -1).reshape(-1, grid.shape[dim]).tolist()


class CollectiveRecord:
    """``with CollectiveRecord(mesh) as record: step(...)`` records the
    collectives this rank runs while it is entered. ``entries``
    holds one dict per collective: ``op`` (the HLO family: all-gather,
    reduce-scatter, all-reduce, all-to-all, collective-permute),
    ``axis`` (the mesh axis, or a tuple of them for a group over the
    whole mesh), ``bytes`` (of this rank's result, as HLO counts a
    collective's result shape), ``dtype`` (of the elements moved, as
    ``torch`` names it without its prefix: ``bfloat16``, ``float32``,
    ``int32``, ``int8``) and ``groups`` (every group of global ranks of
    the mesh along that axis, as ``replica_groups``; for
    collective-permute the (source, target) pairs)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.entries: List[Dict] = []
        self._mode = None

    # the groups of a process group's ranks, by the mesh axis that holds them
    def _locate(self, ranks: List[int]):
        for axis in self.mesh.mesh_dim_names:
            groups = _axis_groups(self.mesh, axis)
            if sorted(ranks) in [sorted(g) for g in groups]:
                return axis, groups
        everyone = self.mesh.mesh.flatten().tolist()
        if sorted(ranks) == sorted(everyone):
            return tuple(self.mesh.mesh_dim_names), [everyone]
        raise ValueError(f"collective over ranks {ranks} lies along no axis of {self.mesh}")

    def _add(self, op, axis, nbytes, dtype, groups):
        self.entries.append({"op": op, "axis": axis, "bytes": int(nbytes),
                             "dtype": str(dtype).removeprefix("torch."), "groups": groups})

    def _on_direct(self, op, axis, x, mesh, perm):
        """A call of ``torchref.collectives``: x is this rank's input."""
        n = C.axis_size(mesh, axis)
        nbytes = x.numel() * x.element_size()
        nbytes = {"all_gather": nbytes * n, "psum_scatter": nbytes // n}.get(op, nbytes)
        groups = _axis_groups(mesh, axis)
        if op == "ppermute":
            groups = [[g[s], g[d]] for g in groups for s, d in perm]
        self._add(_LEDGER_FAMILIES[op], axis, nbytes, x.dtype, groups)

    def _on_funcol(self, op, args, out):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        name = [a for a in args if isinstance(a, str)][-1]
        ranks = dist.get_process_group_ranks(_resolve_process_group(name))
        axis, groups = self._locate(ranks)
        self._add(op, axis, out.numel() * out.element_size(), out.dtype, groups)

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        record, families = self, _funcol_families()

        class _Watch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented  # let DTensor lower itself to collectives first
                out = func(*args, **(kwargs or {}))
                op = families.get(getattr(func, "_overloadpacket", None))
                if op is not None:
                    record._on_funcol(op, args, out)
                return out

        self._mode = _Watch()
        self._mode.__enter__()
        C.LISTENERS.append(self._on_direct)
        return self

    def __exit__(self, *exc):
        C.LISTENERS.remove(self._on_direct)
        self._mode.__exit__(*exc)
        self._mode = None
        return False


def collective_bytes(record: CollectiveRecord) -> Dict[str, float]:
    """The result bytes of each collective op family in the record
    (``hlo_collective_bytes``' return shape)."""
    out: Dict[str, float] = {}
    for e in record.entries:
        out[e["op"]] = out.get(e["op"], 0.0) + e["bytes"]
    return out


def replica_groups(record: CollectiveRecord) -> Dict[str, list]:
    """``{op_family: [[group, ...], ...]}``, one list of groups per
    collective in the record (``hlo_replica_groups``' return shape); for
    collective-permute the source-target pairs as 2-lists."""
    out: Dict[str, list] = {}
    for e in record.entries:
        out.setdefault(e["op"], []).append(e["groups"])
    return out


def group_structure(groups: list) -> Dict[str, object]:
    """(size, stride, contiguous) of a replica-group list — the
    placement signature ``place_group`` consumes. Requires all groups in
    the list to share one structure (true for mesh collectives)."""
    sizes = {len(g) for g in groups}
    assert len(sizes) == 1, f"ragged replica groups: {groups}"
    size = sizes.pop()
    strides = set()
    for g in groups:
        if len(g) >= 2:
            ds = {b - a for a, b in zip(g, g[1:])}
            assert len(ds) == 1, f"non-uniform stride in group {g}"
            strides.add(ds.pop())
    stride = strides.pop() if strides else 1
    assert not strides, f"mixed strides across groups: {groups}"
    return {"size": size, "stride": stride, "contiguous": stride == 1}
