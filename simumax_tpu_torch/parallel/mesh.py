"""Rank <-> parallel-group mapping.

Reference: ``get_rank_group`` (``simumax/core/utils.py:215-249``) —
rank grouping for order tp-cp-dp-pp and etp-ep-edp-pp. Used by tooling
that needs the concrete group membership of every rank (e.g. building
``jax.sharding`` device assignments for a real job that matches the
simulated strategy, or labelling multi-host traces).

Copy of the JAX package's ``parallel/mesh.py`` with its import paths
changed.
"""

from __future__ import annotations

from typing import Dict, List

from simumax_tpu_torch.core.config import StrategyConfig
from simumax_tpu_torch.core.errors import SimulationError

#: innermost-first dim orders (rank = sum_i idx_i * stride_i)
DENSE_ORDER = ("tp", "cp", "dp", "pp")
MOE_ORDER = ("etp", "ep", "edp", "pp")


def _sizes(st: StrategyConfig, order) -> List[int]:
    return [
        {
            "tp": st.tp_size, "cp": st.cp_size, "dp": st.dp_size,
            "pp": st.pp_size, "etp": st.etp_size, "ep": st.ep_size,
            "edp": st.edp_size,
        }[d]
        for d in order
    ]


def _dense_order(st: StrategyConfig):
    """The strategy's dense placement order (``mesh_order``), so real
    device assignments match what the simulator placed on the torus."""
    return tuple(st.mesh_order.split(","))


def rank_coords(rank: int, st: StrategyConfig, order=None) -> Dict[str, int]:
    """Decompose a global rank into per-dim indices (innermost-first)."""
    if order is None:
        order = _dense_order(st)
    coords = {}
    rem = rank
    for dim, size in zip(order, _sizes(st, order)):
        coords[dim] = rem % size
        rem //= size
    return coords


def rank_groups(st: StrategyConfig, dim: str, order=None) -> List[List[int]]:
    """All groups of ranks that communicate over ``dim``: ranks whose
    coords differ only in ``dim``."""
    if order is None:
        order = (
            MOE_ORDER if dim in ("etp", "ep", "edp") else _dense_order(st)
        )
    assert dim in order, (dim, order)
    sizes = _sizes(st, order)
    world = 1
    for s in sizes:
        world *= s
    assert world == st.world_size, (world, st.world_size, order)
    groups: Dict[tuple, List[int]] = {}
    for rank in range(st.world_size):
        coords = rank_coords(rank, st, order)
        key = tuple(v for d, v in coords.items() if d != dim)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


def group_of(rank: int, st: StrategyConfig, dim: str) -> List[int]:
    for g in rank_groups(st, dim):
        if rank in g:
            return g
    raise SimulationError(
        f"rank {rank} is in no {dim!r} group", rank=rank, dim=dim
    )
