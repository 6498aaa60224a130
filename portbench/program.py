"""The system under test: the port's training step, built from a cell.

The harness reaches the port through its step factories and config
classes alone, each model kind its own (``portbench/kinds/<kind>.py``:
``torchref.model.make_train_step(LlamaConfig(...))`` for ``dense``,
``torchref.moe_model.make_train_step(MoeConfig(...))`` for ``moe``). Each
returns ``(init_opt, train_step)``; ``train_step(params, opt_state, (ids,
targets))`` runs the forward, the backward and the Adam update in place and
returns ``(params, opt_state, loss)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from portbench.manifest import load_kind
from portbench.weights import Model

#: the config class's field that takes each cell choice, and the value that
#: asks for it
CELL_FIELDS = {"attention": ("use_flash_attn", "flash"), "linear": ("use_int8", "int8")}


def build(m: Model, cell: Dict, opt: Dict) -> Tuple[Callable, Callable]:
    """(init_opt, train_step) of the port for model ``m`` under ``cell``
    (its ``linear``: bf16 or int8; its ``attention``: flash or math), as
    ``m``'s kind builds it."""
    if cell["linear"] not in ("bf16", "int8") or cell["attention"] not in ("flash", "math"):
        raise ValueError(f"cell: unknown linear {cell['linear']!r} or attention "
                         f"{cell['attention']!r}")
    return load_kind(m.kind).build(m, cell, opt)


def port_config(cls, cell: Dict, **fields):
    """``cls(**fields)``, the port's config class, with the cell's
    ``attention`` and ``linear`` as ``use_flash_attn`` and ``use_int8``
    where ``cls`` declares that field; a cell that asks for flash or int8
    of a class that does not is refused."""
    declared = {f.name for f in dataclasses.fields(cls)}
    for choice, (field, wanted) in CELL_FIELDS.items():
        if field in declared:
            fields[field] = cell[choice] == wanted
        elif cell[choice] == wanted:
            raise ValueError(f"{cls.__name__}: the step runs bf16 linear layers and math "
                             "attention only")
    return cls(**fields)
