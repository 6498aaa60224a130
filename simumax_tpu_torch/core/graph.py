"""Computation-graph capture of the symbolic forward (L6).

Reference: ``simumax/core/graph.py`` (ONNX-style node capture wired into
``MetaModule.__call__``, JSON export + Graphviz rendering with
recompute coloring). Enabled via the ``ENABLE_SIMU_GRAPH`` env var or
``PerfLLM.run_estimate(capture_graph=True)``; edges are recovered from
TensorSpec uids, so no explicit wiring is needed in the ops.

Copy of the JAX package's ``core/graph.py``; its JSON schema tag is
``simumax_tpu_torch_graph_v1``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class GraphNode:
    name: str
    op_type: str
    inputs: List[int]
    outputs: List[int]
    recompute: bool = False
    variance: bool = False  # segment tail skipped under recompute_variance
    fwd_ms: float = 0.0
    cache_mib: float = 0.0


class GraphBuilder:
    """Collects one node per called leaf; edges via tensor uids."""

    def __init__(self):
        self.nodes: List[GraphNode] = []
        self._producer: Dict[int, int] = {}  # tensor uid -> node idx

    def add(self, leaf):
        idx = len(self.nodes)
        node = GraphNode(
            name=leaf.path_name(),
            op_type=type(leaf).__name__,
            inputs=[t.uid for t in leaf.inputs],
            outputs=[t.uid for t in leaf.outputs],
            recompute=leaf.in_recompute,
            variance=getattr(leaf, "variance_tail", False),
            fwd_ms=leaf.cost_info.fwd_time * 1e3,
            cache_mib=leaf.act_info.cache_bytes / 2**20,
        )
        self.nodes.append(node)
        for uid in node.outputs:
            self._producer[uid] = idx

    def edges(self) -> List[tuple]:
        out = []
        for i, node in enumerate(self.nodes):
            for uid in node.inputs:
                src = self._producer.get(uid)
                if src is not None and src != i:
                    out.append((src, i))
        return out

    # -- exports -----------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "schema": "simumax_tpu_torch_graph_v1",
            "nodes": [vars(n) for n in self.nodes],
            "edges": self.edges(),
        }

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    def to_dot(self) -> str:
        """Graphviz DOT text (render with ``dot -Tsvg``); recomputed
        nodes tinted, node label = op + fwd time + cache."""
        lines = ["digraph simumax {", "  rankdir=TB;", "  node [shape=box, fontsize=9];"]
        for i, n in enumerate(self.nodes):
            if n.variance:
                color = "yellow"  # replay-skipped tail (reference graph.py:322)
            elif n.recompute:
                color = "lightsalmon"
            else:
                color = "lightblue2"
            label = f"{n.name}\\n{n.op_type} {n.fwd_ms:.3f}ms {n.cache_mib:.1f}MiB"
            lines.append(
                f'  n{i} [label="{label}", style=filled, fillcolor={color}];'
            )
        for src, dst in self.edges():
            lines.append(f"  n{src} -> n{dst};")
        lines.append("}")
        return "\n".join(lines)

    def save_dot(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_dot())
        return path

    def render(self, path: str, fmt: str = "svg") -> str:
        """Render via the ``graphviz`` python package when a ``dot``
        binary is available (reference ``visualize_with_graphviz``
        ``graph.py:272-352``); otherwise fall back to writing the DOT
        source next to ``path`` so the user can render elsewhere."""
        try:
            import graphviz

            src = graphviz.Source(self.to_dot())
            return src.render(outfile=f"{path}.{fmt}", cleanup=True)
        except Exception:  # no dot binary / package: DOT text fallback
            return self.save_dot(f"{path}.dot")
