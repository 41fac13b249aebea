"""Body-graph construction, in numpy only.

Port of ``deepof_tpu/core/graph.py``. The JAX package builds the skeleton
with networkx; the machine with the card has no networkx, so this module
carries a small undirected graph that keeps networkx's insertion-ordered
adjacency rules. Those rules decide the order of bridges and of the two end
nodes inside each bridge, which name the angle columns, so they are
reproduced exactly: dict-of-lists construction, in-place relabelling,
composition and edge iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Skeleton presets: node -> list of neighbours (deepof_tpu/core/graph.py:24).
GRAPH_PRESETS: Dict[str, Dict[str, List[str]]] = {
    "deepof_14": {
        "Nose": ["Left_ear", "Right_ear"],
        "Spine_1": ["Center", "Left_ear", "Right_ear"],
        "Center": ["Left_fhip", "Right_fhip", "Spine_2"],
        "Spine_2": ["Left_bhip", "Right_bhip", "Tail_base"],
        "Tail_base": ["Tail_1"],
        "Tail_1": ["Tail_2"],
        "Tail_2": ["Tail_tip"],
    },
    "deepof_11": {
        "Nose": ["Left_ear", "Right_ear"],
        "Spine_1": ["Center", "Left_ear", "Right_ear"],
        "Center": ["Left_fhip", "Right_fhip", "Spine_2"],
        "Spine_2": ["Left_bhip", "Right_bhip", "Tail_base"],
    },
    "deepof_8": {
        "Nose": ["Left_ear", "Right_ear"],
        "Center": ["Left_fhip", "Right_fhip", "Tail_base", "Left_ear", "Right_ear"],
        "Tail_base": ["Tail_tip"],
    },
}

# Area polygons; vertex order is load-bearing for the shoelace formula.
AREA_POLYGONS: Dict[str, List[str]] = {
    "head_area": ["Nose", "Left_ear", "Left_fhip", "Spine_1"],
    "torso_area": ["Spine_1", "Right_fhip", "Spine_2", "Left_fhip"],
    "back_area": ["Spine_1", "Right_bhip", "Spine_2", "Left_bhip"],
    "full_area": [
        "Nose", "Left_ear", "Left_fhip", "Left_bhip",
        "Tail_base", "Right_bhip", "Right_fhip", "Right_ear",
    ],
}


class SkeletonGraph:
    """Undirected simple graph with insertion-ordered adjacency.

    Node order, neighbour order and edge order follow networkx.Graph.
    """

    def __init__(self, adjacency: Optional[Dict[str, Iterable[str]]] = None):
        self.adj: Dict[str, Dict[str, None]] = {}
        if adjacency is not None:
            # networkx.from_dict_of_lists: every key first, then the edges.
            for node in adjacency:
                self.add_node(node)
            for node, nbrs in adjacency.items():
                for nbr in nbrs:
                    self.add_edge(node, nbr)

    @property
    def nodes(self) -> List[str]:
        return list(self.adj)

    def __contains__(self, node) -> bool:
        return node in self.adj

    def __getitem__(self, node) -> List[str]:
        return list(self.adj[node])

    def add_node(self, node: str) -> None:
        self.adj.setdefault(node, {})

    def add_edge(self, u: str, v: str) -> None:
        self.add_node(u)
        self.add_node(v)
        self.adj[u][v] = None
        self.adj[v][u] = None

    def remove_node(self, node: str) -> None:
        for nbr in list(self.adj[node]):
            del self.adj[nbr][node]
        del self.adj[node]

    def remove_nodes_from(self, nodes: Iterable[str]) -> None:
        for node in nodes:
            if node in self.adj:
                self.remove_node(node)

    def relabel(self, mapping: Dict[str, str]) -> None:
        """In-place relabelling for disjoint old/new label sets
        (networkx ``relabel_nodes(copy=False)``)."""
        for old in [n for n in self.adj if n in mapping]:
            new = mapping[old]
            self.add_node(new)
            if new == old:
                continue
            new_edges = [(new, new if t == old else t) for t in self.adj[old]]
            self.remove_node(old)
            for u, v in new_edges:
                self.add_edge(u, v)

    def edges(self) -> List[Tuple[str, str]]:
        out, seen = [], set()
        for node, nbrs in self.adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    out.append((node, nbr))
            seen.add(node)
        return out

    def degree(self) -> List[Tuple[str, int]]:
        return [(n, len(nbrs) + (n in nbrs)) for n, nbrs in self.adj.items()]


def compose(first: SkeletonGraph, second: SkeletonGraph) -> SkeletonGraph:
    """networkx ``compose``: nodes then edges of each graph, in order."""
    out = SkeletonGraph()
    for g in (first, second):
        for node in g.nodes:
            out.add_node(node)
        for u, v in g.edges():
            out.add_edge(u, v)
    return out


def connect_mouse(
    animal_ids=None,
    exclude_bodyparts: Optional[List[str]] = None,
    graph_preset="deepof_14",
) -> SkeletonGraph:
    """Skeleton connectivity for one or more animals.

    Multi-animal graphs prefix each node with ``{animal_id}_`` and join the
    animals Nose-Nose, Tail_base-Tail_base and Nose-Tail_base both ways
    (deepof_tpu/core/graph.py:60).
    """
    if animal_ids is None:
        animal_ids = [""]
    if not isinstance(animal_ids, list):
        animal_ids = [animal_ids]

    graphs = []
    for aid in animal_ids:
        adjacency = (
            GRAPH_PRESETS[graph_preset] if isinstance(graph_preset, str)
            else graph_preset
        )
        g = SkeletonGraph(adjacency)
        exclude = exclude_bodyparts
        if aid:
            g.relabel({n: f"{aid}_{n}" for n in g.nodes})
            if exclude_bodyparts is not None:
                exclude = [f"{aid}_{e}" for e in exclude_bodyparts]
        if exclude is not None:
            g.remove_nodes_from(exclude)
        graphs.append(g)

    graph = graphs[0]
    for g in graphs[1:]:
        graph = compose(graph, g)

    for a, b in combinations(animal_ids, 2):
        graph.add_edge(f"{a}_Nose", f"{b}_Nose")
        graph.add_edge(f"{a}_Tail_base", f"{b}_Tail_base")
        graph.add_edge(f"{a}_Nose", f"{b}_Tail_base")
        graph.add_edge(f"{b}_Nose", f"{a}_Tail_base")
    return graph


def enumerate_all_bridges(graph: SkeletonGraph) -> List[List[str]]:
    """All 3-node paths (a, center, b): for every node of degree >= 2, all
    unordered neighbour pairs in neighbour-insertion order."""
    bridges = []
    for center, deg in graph.degree():
        if deg >= 2:
            for a, b in combinations(graph[center], 2):
                bridges.append([a, center, b])
    return bridges


@dataclass(frozen=True)
class BodyGraph:
    """Static skeleton lowered to index arrays (see deepof_tpu BodyGraph)."""

    nodes: Tuple[str, ...]
    edges: np.ndarray
    edge_names: Tuple[Tuple[str, str], ...]
    bridges: np.ndarray
    bridge_names: Tuple[Tuple[str, str, str], ...]
    adjacency: np.ndarray
    area_polys: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)
    animal_ids: Tuple[str, ...] = ("",)
    graph: SkeletonGraph = None

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return len(self.edge_names)

    def node_index(self, name: str) -> int:
        return self.nodes.index(name)


def build_body_graph(
    bodyparts: Sequence[str],
    animal_ids: Optional[Sequence[str]] = None,
    graph_preset="deepof_14",
    exclude_bodyparts: Optional[List[str]] = None,
) -> BodyGraph:
    """Lower the skeleton to index arrays against a node ordering
    (deepof_tpu/core/graph.py:164)."""
    if animal_ids is None or len(animal_ids) == 0:
        animal_ids = [""]
    animal_ids = list(animal_ids)

    graph = connect_mouse(
        animal_ids if animal_ids != [""] else None,
        exclude_bodyparts=exclude_bodyparts,
        graph_preset=graph_preset,
    )
    nodes = tuple(bp for bp in bodyparts if bp in graph)
    idx = {n: i for i, n in enumerate(nodes)}

    edge_rows, edge_names = [], []
    for a, b in graph.edges():
        if a in idx and b in idx:
            na, nb = sorted((a, b))
            edge_rows.append((idx[na], idx[nb]))
            edge_names.append((na, nb))
    order = np.argsort([f"{a}|{b}" for a, b in edge_names], kind="stable")
    edges = np.asarray(edge_rows, dtype=np.int32).reshape(-1, 2)[order]
    edge_names = tuple(edge_names[i] for i in order)

    # Bridges come from each animal's own graph, so their order matches the
    # per-animal connectivity the angle columns are named by.
    bridge_rows, bridge_names = [], []
    for aid in animal_ids:
        sub = connect_mouse(
            aid if aid else None,
            exclude_bodyparts=exclude_bodyparts,
            graph_preset=graph_preset,
        )
        for a, c, b in enumerate_all_bridges(sub):
            if a in idx and b in idx and c in idx:
                bridge_rows.append((idx[a], idx[c], idx[b]))
                bridge_names.append((a, c, b))
    bridges = np.asarray(bridge_rows, dtype=np.int32).reshape(-1, 3)

    adjacency = np.zeros((len(nodes), len(nodes)), dtype=np.float32)
    for i, j in edges:
        adjacency[i, j] = adjacency[j, i] = 1.0

    area_polys: Dict[str, Dict[str, np.ndarray]] = {}
    for aid in animal_ids:
        polys = {}
        for area_name, pattern in AREA_POLYGONS.items():
            named = [f"{aid}_{bp}" if aid else bp for bp in pattern]
            if area_name == "full_area":
                named = [bp for bp in named if bp in idx]
                if len(named) < 3:
                    continue
            elif not all(bp in idx for bp in named):
                continue
            polys[area_name] = np.asarray([idx[bp] for bp in named], dtype=np.int32)
        area_polys[aid] = polys

    return BodyGraph(
        nodes=nodes,
        edges=edges,
        edge_names=edge_names,
        bridges=bridges,
        bridge_names=tuple(bridge_names),
        adjacency=adjacency,
        area_polys=area_polys,
        animal_ids=tuple(animal_ids),
        graph=graph,
    )
