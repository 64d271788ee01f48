"""Minimum edge coloring of bipartite graphs, a copy of
``ldpc_tpu.ckt_noise.bipartite_edge_coloring`` (reference: src_python/ldpc/ckt_noise/bipartite_edge_coloring.py).

By König's theorem a bipartite graph is Δ-edge-colorable. This
implementation inserts edges one at a time: pick a color free at each
endpoint; if they differ, flip the alternating (Kempe) chain of the two
colors starting from one endpoint to free a common color. Colors are
returned 1-indexed in the sparse matrix's data field — they double as
CNOT time steps in the syndrome-extraction circuit generator.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Set

import numpy as np
from scipy.sparse import csc_matrix, csr_matrix


@dataclass
class Node:
    """One side-A or side-B node's edge-coloring state
    (reference: bipartite_edge_coloring.py:11-46)."""

    uncolored_edges: Set[int] = field(default_factory=set)
    colored_edges: Dict[int, int] = field(default_factory=dict)
    colors_available: Set[int] = field(default_factory=set)

    def add_color_to_uncolored_edge(self, dest: int, col: int) -> None:
        self.colored_edges[col] = dest
        self.colors_available.discard(col)
        self.uncolored_edges.discard(dest)

    def swap_edge_colors(self, color_1: int, color_2: int) -> None:
        c1, c2 = self.colored_edges[color_1], self.colored_edges[color_2]
        self.colored_edges[color_1] = c2
        self.colored_edges[color_2] = c1

    def change_edge_color(self, dest: int, from_col: int, to_col: int) -> None:
        assert self.colored_edges[from_col] == dest
        del self.colored_edges[from_col]
        self.colors_available.add(from_col)
        self.colored_edges[to_col] = dest
        self.colors_available.discard(to_col)
        self.uncolored_edges.discard(dest)


class BipartiteGraph:
    """Bipartite graph with per-node edge-coloring state
    (reference: bipartite_edge_coloring.py:48-253). The coloring itself
    delegates to :func:`bipartite_edge_coloring`."""

    def __init__(self, num_a_nodes: int, num_b_nodes: int):
        self.a_nodes = [Node() for _ in range(num_a_nodes)]
        self.b_nodes = [Node() for _ in range(num_b_nodes)]
        self.degree = 0

    def add_edge(self, i: int, j: int) -> None:
        self.a_nodes[i].uncolored_edges.add(j)
        self.b_nodes[j].uncolored_edges.add(i)

    @staticmethod
    def from_biadjacency_matrix(biadj) -> "BipartiteGraph":
        biadj = csr_matrix(biadj)
        graph = BipartiteGraph(biadj.shape[0], biadj.shape[1])
        for i in range(biadj.shape[0]):
            for j in biadj.indices[biadj.indptr[i] : biadj.indptr[i + 1]]:
                graph.add_edge(i, int(j))
        deg_a = max(
            (len(n.uncolored_edges) for n in graph.a_nodes), default=0
        )
        deg_b = max(
            (len(n.uncolored_edges) for n in graph.b_nodes), default=0
        )
        graph.degree = max(deg_a, deg_b)  # chromatic index (König)
        for node in graph.a_nodes + graph.b_nodes:
            node.colors_available = set(range(graph.degree))
        return graph

    def bipartite_edge_coloring(self) -> None:
        """Color every uncolored edge in place (0-indexed colors)."""
        colored = bipartite_edge_coloring(self.to_biadjacency_matrix())
        colored = csr_matrix(colored)
        for i in range(colored.shape[0]):
            for ptr in range(colored.indptr[i], colored.indptr[i + 1]):
                j = int(colored.indices[ptr])
                col = int(colored.data[ptr]) - 1
                if j in self.a_nodes[i].uncolored_edges:
                    self.a_nodes[i].add_color_to_uncolored_edge(j, col)
                    self.b_nodes[j].add_color_to_uncolored_edge(i, col)

    def assert_has_edge_coloring(self) -> None:
        for nodes, others in (
            (self.a_nodes, self.b_nodes),
            (self.b_nodes, self.a_nodes),
        ):
            for i, node in enumerate(nodes):
                assert not node.uncolored_edges
                assert len(node.colored_edges) == len(
                    set(node.colored_edges.values())
                )
                for col, j in node.colored_edges.items():
                    assert others[j].colored_edges.get(col) == i

    def to_biadjacency_matrix(self) -> csr_matrix:
        """0/1 sparsity pattern of all edges (colored + uncolored)."""
        rows, cols = [], []
        for i, node in enumerate(self.a_nodes):
            for j in node.uncolored_edges:
                rows.append(i)
                cols.append(j)
            for j in node.colored_edges.values():
                rows.append(i)
                cols.append(j)
        return csr_matrix(
            (np.ones(len(rows), dtype=np.int64), (rows, cols)),
            shape=(len(self.a_nodes), len(self.b_nodes)),
        )


def bipartite_edge_coloring(biadjacency_matrix) -> csr_matrix:
    """Color the edges of the bipartite graph given by a biadjacency
    matrix with exactly Δ colors. Returns a csr_matrix of the same
    sparsity pattern whose data are the 1-indexed colors."""
    biadj = csr_matrix(biadjacency_matrix)
    biadj.eliminate_zeros()
    biadj.sort_indices()
    na, nb = biadj.shape
    deg_a = np.diff(biadj.indptr)
    deg_b = np.bincount(biadj.indices, minlength=nb)
    delta = int(max(deg_a.max(initial=0), deg_b.max(initial=0)))

    # color -> neighbour maps per node (None-free colors are available)
    a_col: List[Dict[int, int]] = [dict() for _ in range(na)]
    b_col: List[Dict[int, int]] = [dict() for _ in range(nb)]

    def free_color(used: Dict[int, int]) -> int:
        for c in range(1, delta + 1):
            if c not in used:
                return c
        raise AssertionError("no free color; degree bound violated")

    def flip_chain(b: int, ca: int, cb: int) -> None:
        """Swap colors ca<->cb along the alternating chain from b, making
        ca free at b. The chain cannot end at the edge's A endpoint:
        that would make an odd-length ca/cb-alternating path whose last
        edge has the wrong parity (ca is free there)."""
        chain = []  # (on_a, u, v, color)
        u, on_a, c = b, False, ca
        while True:
            cols = a_col[u] if on_a else b_col[u]
            if c not in cols:
                break
            v = cols[c]
            chain.append((on_a, u, v, c))
            u, on_a, c = v, not on_a, (cb if c == ca else ca)
        for on_a, u, v, c in chain:  # remove all, then re-add swapped
            (a_col[u] if on_a else b_col[u]).pop(c)
            (b_col[v] if on_a else a_col[v]).pop(c)
        for on_a, u, v, c in chain:
            newc = cb if c == ca else ca
            (a_col[u] if on_a else b_col[u])[newc] = v
            (b_col[v] if on_a else a_col[v])[newc] = u

    for a in range(na):
        for b in biadj.indices[biadj.indptr[a] : biadj.indptr[a + 1]]:
            b = int(b)
            ca = free_color(a_col[a])
            cb = free_color(b_col[b])
            if ca != cb:
                flip_chain(b, ca, cb)
            a_col[a][ca] = b
            b_col[b][ca] = a

    data = np.zeros(biadj.nnz, dtype=np.int64)
    k = 0
    for a in range(na):
        for b in biadj.indices[biadj.indptr[a] : biadj.indptr[a + 1]]:
            # find the color of edge (a, b)
            for c, nb_ in a_col[a].items():
                if nb_ == int(b):
                    data[k] = c
                    break
            k += 1
    return csr_matrix(
        (data, biadj.indices.copy(), biadj.indptr.copy()), shape=biadj.shape
    )


def is_valid_bipartite_edge_coloring(
    biadj_matrix, colored_biadj_matrix
) -> bool:
    """Validate a minimum edge coloring
    (reference: bipartite_edge_coloring.py:255-319): same sparsity
    pattern, colors in [1, Δ], no color repeated at any node."""
    m = csr_matrix(biadj_matrix)
    m.eliminate_zeros()
    m.sort_indices()
    mc = csr_matrix(colored_biadj_matrix)
    mc.eliminate_zeros()
    mc.sort_indices()
    if m.shape != mc.shape:
        return False
    if not (
        np.array_equal(m.indices, mc.indices)
        and np.array_equal(m.indptr, mc.indptr)
    ):
        return False
    if np.any(mc.data < 1):
        return False
    m_csc = csc_matrix(mc)
    row_w = np.max(mc.indptr[1:] - mc.indptr[:-1], initial=0)
    col_w = np.max(m_csc.indptr[1:] - m_csc.indptr[:-1], initial=0)
    degree = max(row_w, col_w)
    if np.any(mc.data > degree):
        return False
    for ms in (mc, m_csc):
        for i in range(ms.indptr.shape[0] - 1):
            cols = ms.data[ms.indptr[i] : ms.indptr[i + 1]]
            if np.unique(cols).shape[0] < cols.shape[0]:
                return False
    return True
