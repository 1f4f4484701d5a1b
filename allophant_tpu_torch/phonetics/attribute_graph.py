"""Attribute dependency graph for the hierarchical classifier.

The port's copy of ``allophant_tpu/phonetics/attribute_graph.py``.

Counterpart of the reference's allophant/attribute_graph.py: a DAG of classifier nodes
(name, size, optional per-node attention config, dependency names) with Tarjan-SCC
cycle detection and reverse-topological ``sort()`` that drives classifier construction
order. Serialization is plain JSON-able dicts (no marshmallow)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

# Acoustic-model output dependencies ("OUTPUT" or "OUTPUT_<i>") are not graph nodes.
OUTPUT_DEPENDENCY = "OUTPUT"
OUTPUT_PATTERN = re.compile(rf"^{OUTPUT_DEPENDENCY}(?:_(\d+))?$")


class DependencyCycleError(Exception):
    """Raised when a dependency cycle is detected."""


@dataclass
class TimeLayerConfig:
    """Multi-head-attention time layer for a classifier node (instead of a linear)."""

    num_heads: int = 1
    positional_embeddings: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {"num_heads": self.num_heads, "positional_embeddings": self.positional_embeddings}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TimeLayerConfig":
        return cls(int(data.get("num_heads", 1)), bool(data.get("positional_embeddings", False)))


@dataclass
class AttributeNode:
    """A phonetic attribute classifier node: name, number of variants, dependencies."""

    name: str
    size: int
    time_layer_config: Optional[TimeLayerConfig] = None
    dependencies: List[str] = field(default_factory=list)

    def with_offset(self, offset: int = 1) -> "AttributeNode":
        return AttributeNode(self.name, self.size + offset, self.time_layer_config, self.dependencies)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "size": self.size,
            "time_layer_config": None
            if self.time_layer_config is None
            else self.time_layer_config.to_dict(),
            "dependencies": list(self.dependencies),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AttributeNode":
        time_layer = data.get("time_layer_config")
        return cls(
            data["name"],
            int(data["size"]),
            None if time_layer is None else TimeLayerConfig.from_dict(time_layer),
            list(data.get("dependencies", [])),
        )


class AttributeGraph:
    """Graph of attribute classifiers with their sizes and dependency edges."""

    def __init__(self, nodes: Iterable[AttributeNode]) -> None:
        self._nodes: List[AttributeNode] = []
        self._node_indices: Dict[str, int] = {}
        for index, node in enumerate(nodes):
            self._nodes.append(node)
            self._node_indices[node.name] = index
        for node in self._nodes:
            for dependency in node.dependencies:
                if not OUTPUT_PATTERN.match(dependency) and dependency not in self._node_indices:
                    raise ValueError(
                        f"Unknown dependency {dependency!r} of classifier {node.name!r}:"
                        " not a classifier name or an acoustic-model output tap"
                        " (OUTPUT/OUTPUT_<layer>)"
                    )
        self._edges: List[List[int]] = [
            [
                self._node_indices[dependency]
                for dependency in node.dependencies
                if not OUTPUT_PATTERN.match(dependency)
            ]
            for node in self._nodes
        ]

    def sizes(self) -> Iterator[int]:
        return (node.size for node in self._nodes)

    def names(self) -> Iterator[str]:
        return (node.name for node in self._nodes)

    @property
    def nodes(self) -> List[AttributeNode]:
        return self._nodes

    def get(self, node: str | int) -> AttributeNode | None:
        if isinstance(node, str):
            node_index = self._node_indices.get(node)
            if node_index is None:
                return None
            node = node_index
        return self._nodes[node]

    def __getitem__(self, node: str | int) -> AttributeNode:
        if isinstance(node, str):
            node = self._node_indices[node]
        return self._nodes[node]

    def __contains__(self, node_name: str) -> bool:
        return node_name in self._node_indices

    def __len__(self) -> int:
        return len(self._nodes)

    def __iter__(self) -> Iterator[AttributeNode]:
        return iter(self._nodes)

    def strongly_connected_components(self) -> Iterator[List[AttributeNode]]:
        """Tarjan's SCC (iterative), yielding components in reverse topological order."""
        count = len(self._nodes)
        if not count:
            return
        index_of = [-1] * count
        lowlink = [0] * count
        on_stack = [False] * count
        stack: List[int] = []
        next_index = 0

        for root in range(count):
            if index_of[root] != -1:
                continue
            # Explicit call stack of (node, edge cursor).
            work: List[Tuple[int, int]] = [(root, 0)]
            while work:
                node, cursor = work.pop()
                if cursor == 0:
                    index_of[node] = lowlink[node] = next_index
                    next_index += 1
                    stack.append(node)
                    on_stack[node] = True
                advanced = False
                edges = self._edges[node]
                while cursor < len(edges):
                    target = edges[cursor]
                    cursor += 1
                    if index_of[target] == -1:
                        work.append((node, cursor))
                        work.append((target, 0))
                        advanced = True
                        break
                    if on_stack[target]:
                        lowlink[node] = min(lowlink[node], index_of[target])
                if advanced:
                    continue
                if lowlink[node] == index_of[node]:
                    component = []
                    while True:
                        member = stack.pop()
                        on_stack[member] = False
                        component.append(member)
                        if member == node:
                            break
                    yield [self._nodes[index] for index in component]
                if work:
                    parent = work[-1][0]
                    lowlink[parent] = min(lowlink[parent], lowlink[node])

    def sort(self) -> Iterator[AttributeNode]:
        """Reverse-topological node order; raises on dependency cycles.

        Unlike the reference (attribute_graph.py:196-199), a self-dependency is
        also rejected: it forms a single-node SCC that Tarjan alone cannot
        distinguish from an acyclic node, yet classifier construction would read
        the node's own logits before they exist."""
        for component in self.strongly_connected_components():
            if len(component) > 1:
                raise DependencyCycleError(
                    "Dependency cycle detected: " + " -> ".join(node.name for node in component)
                )
            node = component[0]
            if self._node_indices[node.name] in self._edges[self._node_indices[node.name]]:
                raise DependencyCycleError(f"Classifier {node.name!r} depends on itself")
            yield node

    def to_dict(self) -> Dict[str, Any]:
        return {
            "nodes": [node.to_dict() for node in self._nodes],
            "node_indices": dict(self._node_indices),
            "edges": [list(edges) for edges in self._edges],
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AttributeGraph":
        graph = cls.__new__(cls)
        graph._nodes = [AttributeNode.from_dict(node) for node in data["nodes"]]
        graph._node_indices = {name: int(index) for name, index in data["node_indices"].items()}
        graph._edges = [list(map(int, edges)) for edges in data["edges"]]
        return graph
