"""Visibility-based camera clustering for the CLUSTER_JACOBI and
CLUSTER_TRIDIAGONAL Schur preconditioners.

The port's own copy of ceres_tpu/solvers/clustering.py (numpy only, the
same arithmetic and iteration order, so memberships and forests are equal
element for element):
  * compute_visibility (visibility.h:51): per f block (camera) the set of
    e blocks (points) it observes;
  * covisibility_graph (visibility.h:76 CreateSchurComplementGraph): the
    camera graph weighted by normalized shared visibility;
  * canonical_views_clustering (canonical_views_clustering.cc:98): greedy
    canonical views maximizing coverage minus size and similarity
    penalties, then nearest-canonical assignment;
  * single_linkage_clustering (single_linkage_clustering.cc:58): connected
    components over edges at or above a similarity threshold;
  * degree2_maximum_spanning_forest (graph_algorithms.h:261): the
    cluster-tridiagonal structure.
Host graph work on the problem's structure, once per program; the
preconditioner's factor and apply are solvers/schur.py's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set, Tuple

import numpy as np


def compute_visibility(program, meta) -> List[Set[int]]:
    """visibility[f_block_id] = set of e-block ids it co-occurs with.
    f-block ids are (group_id, local_id) flattened in f_groups order."""
    # map (gi, li) -> flat id
    flat = {}
    count = 0
    for gi, grp in enumerate(meta.f_groups):
        for li in range(grp["kf"]):
            flat[(gi, li)] = count
            count += 1
    vis = [set() for _ in range(count)]
    for gi, grp in enumerate(meta.f_groups):
        for k, (bi, var_si, local) in enumerate(grp["slots"]):
            bs = meta.buckets[bi]
            if bs.e_ids is None:
                continue
            for li, ei in zip(local, bs.e_ids):
                vis[flat[(gi, int(li))]].add(int(ei))
    return vis


def covisibility_graph(visibility: List[Set[int]]) -> Dict[Tuple[int, int],
                                                            float]:
    """Edges weighted by normalized shared visibility
    (CreateSchurComplementGraph)."""
    point_to_cams = defaultdict(list)
    for c, pts in enumerate(visibility):
        for p in pts:
            point_to_cams[p].append(c)
    weights = defaultdict(int)
    for p, cams in point_to_cams.items():
        for i in range(len(cams)):
            for j in range(i + 1, len(cams)):
                a, b = cams[i], cams[j]
                if a > b:
                    a, b = b, a
                weights[(a, b)] += 1
    out = {}
    for (a, b), w in weights.items():
        denom = np.sqrt(len(visibility[a]) * len(visibility[b]))
        out[(a, b)] = w / denom if denom > 0 else 0.0
    return out


def canonical_views_clustering(visibility: List[Set[int]],
                               graph: Dict[Tuple[int, int], float],
                               min_views: int = 3,
                               size_penalty_weight: float = 5.75,
                               similarity_penalty_weight: float = 100.0
                               ) -> np.ndarray:
    """Greedy canonical-view selection (canonical_views_clustering.cc:98):
    repeatedly pick the view maximizing (coverage gain - size penalty -
    similarity-to-chosen penalty); assign every camera to its most similar
    canonical view. Returns cluster id per camera."""
    n = len(visibility)
    sim = defaultdict(float)
    for (a, b), w in graph.items():
        sim[(a, b)] = w
        sim[(b, a)] = w

    chosen: List[int] = []
    covered: Dict[int, float] = {}   # point -> best weight so far (0/1 here)

    def gain(c):
        g = 0.0
        for p in visibility[c]:
            if p not in covered:
                g += 1.0
        g -= size_penalty_weight
        for s in chosen:
            g -= similarity_penalty_weight * sim[(c, s)] \
                if (c, s) in sim else 0.0
        return g

    candidates = set(range(n))
    while candidates and len(chosen) < max(1, n):
        best, best_gain = None, 0.0
        for c in candidates:
            g = gain(c)
            if g > best_gain:
                best, best_gain = c, g
        if best is None:
            break
        chosen.append(best)
        candidates.discard(best)
        for p in visibility[best]:
            covered[p] = 1.0
        if len(chosen) >= n // max(min_views, 1) + 1:
            break
    if not chosen:
        chosen = [0]

    membership = np.zeros(n, dtype=np.int64)
    for c in range(n):
        best, best_sim = 0, -1.0
        for k, s in enumerate(chosen):
            w = sim.get((c, s), 0.0) if c != s else np.inf
            if w > best_sim:
                best, best_sim = k, w
        membership[c] = best
    return membership


def single_linkage_clustering(n: int, graph: Dict[Tuple[int, int], float],
                              min_similarity: float = 0.9) -> np.ndarray:
    """Union-find over edges with weight >= min_similarity
    (single_linkage_clustering.cc:58)."""
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (a, b), w in graph.items():
        if w >= min_similarity:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
    roots = {}
    out = np.zeros(n, dtype=np.int64)
    for c in range(n):
        r = find(c)
        out[c] = roots.setdefault(r, len(roots))
    return out


def degree2_maximum_spanning_forest(num_clusters: int,
                                    edges: Dict[Tuple[int, int], float]
                                    ) -> List[Tuple[int, int]]:
    """Greedy max-weight forest with per-vertex degree <= 2
    (graph_algorithms.h:261 Degree2MaximumSpanningForest) — gives the
    cluster-tridiagonal structure."""
    degree = [0] * num_clusters
    parent = list(range(num_clusters))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    chosen = []
    for (a, b), w in sorted(edges.items(), key=lambda kv: -kv[1]):
        if degree[a] >= 2 or degree[b] >= 2:
            continue
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        parent[ra] = rb
        degree[a] += 1
        degree[b] += 1
        chosen.append((a, b))
    return chosen


def cluster_membership(program, meta, kind: str,
                       clustering_type: str = "CANONICAL_VIEWS"):
    """Returns (membership [num_f_blocks], forest edges or None).

    kind selects the preconditioner structure (CLUSTER_JACOBI = cluster-
    diagonal only, CLUSTER_TRIDIAGONAL = + degree-2 max spanning forest);
    clustering_type selects the clustering algorithm, matching the
    reference's Preconditioner::Options::visibility_clustering_type
    (visibility_based_preconditioner.cc ClusterCameras)."""
    vis = compute_visibility(program, meta)
    graph = covisibility_graph(vis)

    def compute_membership():
        if str(clustering_type).upper().endswith("SINGLE_LINKAGE"):
            return single_linkage_clustering(len(vis), graph,
                                             min_similarity=0.9)
        return canonical_views_clustering(vis, graph)

    if kind == "CLUSTER_JACOBI":
        return compute_membership(), None
    # CLUSTER_TRIDIAGONAL: cluster then forest between clusters
    membership = compute_membership()
    ncl = int(membership.max()) + 1 if membership.size else 1
    cedges = defaultdict(float)
    for (a, b), w in graph.items():
        ca, cb = int(membership[a]), int(membership[b])
        if ca == cb:
            continue
        if ca > cb:
            ca, cb = cb, ca
        cedges[(ca, cb)] += w
    forest = degree2_maximum_spanning_forest(ncl, cedges)
    return membership, forest
