"""Model DAG + inference trace, as in the JAX package's `zkml/model.py`.

A `Model` is a DAG of nodes, each with ordered input edges pointing at
another node's output or a model input. `run` executes nodes in
topological order on the chosen device and records every step's
inputs/outputs -- the `InferenceTrace` the prover consumes.
"""

from __future__ import annotations

import dataclasses

from .. import device as device_mod
from .tensor import Tensor

NodeId = int


@dataclasses.dataclass(frozen=True)
class Edge:
    """Input edge: from a node's output (node != None) or model input."""

    node: NodeId | None
    index: int = 0


@dataclasses.dataclass
class Node:
    id: NodeId
    op: object
    inputs: list[Edge]


@dataclasses.dataclass
class StepData:
    inputs: list[Tensor]
    outputs: list[Tensor]


@dataclasses.dataclass
class InferenceTrace:
    steps: dict  # NodeId -> StepData
    inputs: list[Tensor]
    outputs: list[Tensor]


class Model:
    def __init__(self, num_inputs: int = 1):
        self.nodes: dict[NodeId, Node] = {}
        self.num_inputs = num_inputs
        self._next_id = 0

    def add_node(self, op, inputs: list[Edge]) -> NodeId:
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = Node(id=nid, op=op, inputs=inputs)
        return nid

    def add_chain(self, op) -> NodeId:
        """Append op consuming the previous node's (or model's) output."""
        if not self.nodes:
            return self.add_node(op, [Edge(node=None, index=0)])
        last = max(self.nodes)
        return self.add_node(op, [Edge(node=last, index=0)])

    def forward_order(self) -> list[NodeId]:
        """Topological order (insertion order is topological by construction)."""
        return sorted(self.nodes)

    def output_nodes(self) -> list[NodeId]:
        """Nodes whose output feeds no other node = model outputs."""
        consumed = {e.node for n in self.nodes.values() for e in n.inputs}
        return [nid for nid in sorted(self.nodes) if nid not in consumed]

    def num_outputs(self, nid: NodeId) -> int:
        """Output-wire count of a node: 1 + max consumed output index."""
        mx = 0
        for n in self.nodes.values():
            for e in n.inputs:
                if e.node == nid:
                    mx = max(mx, e.index)
        return mx + 1

    def consumers_of_wire(self, nid: NodeId, wire: int) -> list[tuple[NodeId, int]]:
        """(consumer_id, input_slot) edges reading output `wire` of `nid`,
        in deterministic (consumer id, slot) order."""
        out = []
        for cid in sorted(self.nodes):
            for slot, e in enumerate(self.nodes[cid].inputs):
                if e.node == nid and e.index == wire:
                    out.append((cid, slot))
        return out

    def run(self, inputs: list[Tensor], device="cuda") -> InferenceTrace:
        dev = device_mod.resolve(device)
        inputs = [Tensor(t.data.to(dev)) for t in inputs]
        values: dict[NodeId, list[Tensor]] = {}
        steps = {}
        for nid in self.forward_order():
            node = self.nodes[nid]
            node_inputs = []
            for e in node.inputs:
                if e.node is None:
                    node_inputs.append(inputs[e.index])
                else:
                    node_inputs.append(values[e.node][e.index])
            outs = node.op.evaluate(node_inputs)
            values[nid] = outs
            steps[nid] = StepData(inputs=node_inputs, outputs=outs)
        outputs = [values[nid][0] for nid in self.output_nodes()]
        return InferenceTrace(steps=steps, inputs=inputs, outputs=outputs)
