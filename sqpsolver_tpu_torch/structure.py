"""Static problem structure: interaction-graph partitioning and AD coloring
(torch port of the JAX package's ``structure.py``; numpy only but for
:func:`detect_structure`).

The block-structured KKT path needs two things from an NLP's sparsity:

* a **vertex-separator partition** of the variable-interaction graph, which
  turns the condensed KKT matrix into bordered-block-diagonal (BBD) form: P
  independent dense diagonal blocks plus a dense separator border, factored
  as batched dense Cholesky plus one dense Schur complement
  (:mod:`sqpsolver_tpu_torch.ops.kkt_bbd`);
* **graph coloring** (Curtis-Powell-Reid), which compresses the derivatives:
  columns that share no constraint row share one JVP seed, so the Jacobian
  costs ``nJ`` JVPs instead of ``n`` and the Lagrangian Hessian ``nH``
  Hessian-vector products.

Everything here runs on the host in numpy when a solver is built; the
products are static index and mask arrays.  The partition is deterministic,
so this module and the JAX package's give identical arrays (held by
``tests/test_torch_structure.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# --------------------------------------------------------------------------
# structural sparsity of an NLP
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NLPStructure:
    """Structural sparsity pattern of an NLP (host-side, static).

    ``row_cols[i]`` lists the variable indices constraint row ``i`` can
    depend on (a superset is safe; a miss is not).  ``obj_pairs`` lists
    additional Hessian coupling pairs introduced by the objective beyond the
    diagonal (``(k, 2)`` int array; the diagonal is always assumed present).
    """

    row_cols: tuple  # tuple of np.ndarray, length m
    obj_pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64)
    )


def detect_structure(nlp, n_probe: int = 3, seed: int = 0) -> NLPStructure:
    """Numerically detect ``row_cols`` by unioning Jacobian supports at a few
    random points (fallback when the model does not provide structure).

    Uses dense ``torch.func.jacfwd`` in float64 on the CPU at ``n_probe``
    perturbed points, the same seeded points as the JAX package; suitable for
    small/medium problems.  Models intended for large-scale structured solves
    (e.g. ACOPF) should supply exact structure instead.
    """
    import torch
    from torch.func import jacfwd

    rng = np.random.default_rng(seed)
    x0 = np.asarray(nlp.x0, dtype=np.float64)
    support = np.zeros((nlp.m, nlp.n), dtype=bool)
    theta = (
        None
        if nlp.theta is None
        else {k: torch.as_tensor(np.asarray(v), dtype=torch.float64) for k, v in nlp.theta.items()}
    )
    for _ in range(n_probe):
        x = x0 + 0.1 * rng.standard_normal(nlp.n) + 0.01
        J = jacfwd(lambda z: nlp.cons(z, theta))(torch.as_tensor(x)).numpy()
        support |= np.abs(J) > 0.0
    rows = tuple(np.nonzero(support[i])[0] for i in range(nlp.m))
    return NLPStructure(row_cols=rows)


# --------------------------------------------------------------------------
# greedy group coloring (Curtis–Powell–Reid)
# --------------------------------------------------------------------------


def color_groups(n: int, groups) -> np.ndarray:
    """Color ``n`` items such that within every group all items have distinct
    colors (greedy, largest-degree-first).  Returns ``colors (n,)``.

    * Jacobian compression: groups = the column sets of each row
      (partial distance-2 coloring of the bipartite graph).
    * Hessian compression: groups = closed neighborhoods of each variable in
      the interaction graph (recovers row ``i`` of H from compressed HVPs).
    """
    # build item -> groups incidence
    item_groups: list[list[int]] = [[] for _ in range(n)]
    for gi, g in enumerate(groups):
        for j in g:
            item_groups[j].append(gi)
    # degree = number of conflicting items (approx: sum of group sizes)
    deg = np.zeros(n, dtype=np.int64)
    gsizes = [len(g) for g in groups]
    for j in range(n):
        deg[j] = sum(gsizes[gi] for gi in item_groups[j])
    order = np.argsort(-deg, kind="stable")
    colors = np.full(n, -1, dtype=np.int64)
    group_used: list[set] = [set() for _ in groups]
    for j in order:
        forbidden = set()
        for gi in item_groups[j]:
            forbidden |= group_used[gi]
        c = 0
        while c in forbidden:
            c += 1
        colors[j] = c
        for gi in item_groups[j]:
            group_used[gi].add(c)
    return colors


def interaction_graph(n: int, structure: NLPStructure):
    """Adjacency (list of sets) of the variable-interaction graph: two
    variables interact if they co-occur in a constraint row or an objective
    pair — the structural envelope of both the Lagrangian Hessian and the
    condensed KKT matrix K = H + A' D A."""
    adj = [set() for _ in range(n)]
    for cols in structure.row_cols:
        for a in cols:
            for b in cols:
                if a != b:
                    adj[a].add(int(b))
    for a, b in structure.obj_pairs:
        if a != b:
            adj[int(a)].add(int(b))
            adj[int(b)].add(int(a))
    return adj


# --------------------------------------------------------------------------
# vertex-separator partition (BFS growing + greedy cover of cross edges)
# --------------------------------------------------------------------------


def partition_vertex_separator(adj, n_parts: int, seed: int = 0):
    """Partition vertices into ``n_parts`` interiors + one separator such
    that no edge joins two distinct interiors.

    BFS region growing (balanced) followed by a greedy vertex cover of the
    cross edges.  Returns ``(parts, sep)`` — a list of index arrays and the
    separator index array.  Simple and deterministic; for power-network
    graphs the separator stays small (boundary buses).
    """
    n = len(adj)
    target = int(np.ceil(n / n_parts))
    assign = np.full(n, -1, dtype=np.int64)  # part id
    rng = np.random.default_rng(seed)
    part_id = 0
    order = np.argsort([len(a) for a in adj], kind="stable")  # low degree first
    for s in order:
        if assign[s] >= 0:
            continue
        # BFS from s collecting up to target unassigned vertices
        frontier = [int(s)]
        assign[s] = part_id
        count = 1
        while frontier and count < target:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if assign[v] < 0 and count < target:
                        assign[v] = part_id
                        nxt.append(int(v))
                        count += 1
            frontier = nxt
        part_id += 1
    # greedy vertex cover of cross edges -> separator
    sep = np.zeros(n, dtype=bool)

    def cross_deg():
        deg = np.zeros(n, dtype=np.int64)
        for u in range(n):
            if sep[u]:
                continue
            for v in adj[u]:
                if not sep[v] and assign[v] != assign[u]:
                    deg[u] += 1
        return deg

    deg = cross_deg()
    while deg.max(initial=0) > 0:
        u = int(np.argmax(deg))
        sep[u] = True
        deg[u] = 0
        for v in adj[u]:
            if not sep[v] and assign[v] != assign[u]:
                deg[v] -= 1
    parts = [
        np.nonzero((assign == p) & ~sep)[0] for p in range(part_id)
    ]
    parts = [p for p in parts if len(p) > 0]
    sep_idx = np.nonzero(sep)[0]
    # invariant: no interior-interior cross edge
    pid = np.full(n, -1)
    for i, p in enumerate(parts):
        pid[p] = i
    for u in range(n):
        if sep[u]:
            continue
        for v in adj[u]:
            if not sep[v]:
                assert pid[u] == pid[v], "separator invariant violated"
    return parts, sep_idx


# --------------------------------------------------------------------------
# block structure: everything the BBD KKT path needs, padded + static
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockStructure:
    """Padded static index/mask arrays for the BBD structured KKT path.

    Shapes: P parts, ``nd`` padded interior size, ``ns`` separator size,
    ``mr`` padded rows per part, ``mre`` padded equality rows per part.
    Padding uses index ``n`` (variables) / ``m`` (rows) pointing at a zero
    pad slot; masks carry the structural nonzero patterns.
    """

    n: int
    m: int
    P: int
    nd: int
    ns: int
    mr: int
    mre: int
    # variable layout
    int_idx: np.ndarray  # (P, nd) global var index, n = pad
    int_mask: np.ndarray  # (P, nd) bool
    sep_idx: np.ndarray  # (ns,)
    var_part: np.ndarray  # (n,) part id, -1 = separator
    var_slot: np.ndarray  # (n,) slot within part interior / separator
    # row layout
    rows: np.ndarray  # (P, mr) global row index, m = pad
    rows_mask: np.ndarray  # (P, mr) bool
    # local Jacobian gather: A_int[p,r,k] = Jc[rows[p,r], colJ_int[p,k]] * Aint_mask
    colorJ: np.ndarray  # (n,) Jacobian colors
    nJ: int  # number of Jacobian colors
    Aint_mask: np.ndarray  # (P, mr, nd) bool structural nonzeros
    Asep_mask: np.ndarray  # (P, mr, ns) bool
    # Hessian gather: H_pp[p,i,j] = Hc[int_idx[p,i], colorH[int_idx[p,j]]] * mask
    colorH: np.ndarray  # (n,)
    nH: int
    Hpp_mask: np.ndarray  # (P, nd, nd) bool
    Hps_mask: np.ndarray  # (P, nd, ns) bool
    Hss_mask: np.ndarray  # (ns, ns) bool
    # equality rows (static stiff candidates for the QP Schur complement)
    eq_rows: np.ndarray  # (P, mre) global row index, m = pad
    eq_rows_mask: np.ndarray  # (P, mre)
    eq_gidx: np.ndarray  # (P, mre) index into the dense eq ordering, m_eq = pad
    eq_local: np.ndarray  # (P, mre) row slot within the part's rows, mr = pad
    m_eq: int
    eq_order: np.ndarray  # (m_eq,) global row index of each dense-eq slot
    is_eq: np.ndarray  # (m,) bool


def _pad_to(arrs, length, pad_value):
    out = np.full((len(arrs), length), pad_value, dtype=np.int64)
    mask = np.zeros((len(arrs), length), dtype=bool)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
        mask[i, : len(a)] = True
    return out, mask


def build_block_structure(
    n: int,
    m: int,
    structure: NLPStructure,
    eq_mask: np.ndarray,
    n_parts: int | None = None,
    pad_multiple: int = 8,
) -> BlockStructure:
    """Assemble the padded BBD structure for an NLP's sparsity pattern.

    ``eq_mask (m,)``: rows with ``g_l == g_u`` — the static stiff candidates
    whose duals go through the dense Schur complement in the structured QP.
    """
    adj = interaction_graph(n, structure)
    if n_parts is None:
        # ~128-variable interiors keep the batched Cholesky blocks tile-sized
        n_parts = max(2, int(np.ceil(n / 128)))
    parts, sep = partition_vertex_separator(adj, n_parts)
    P = len(parts)
    ns = len(sep)

    var_part = np.full(n, -1, dtype=np.int64)
    var_slot = np.zeros(n, dtype=np.int64)
    for i, p in enumerate(parts):
        var_part[p] = i
        var_slot[p] = np.arange(len(p))
    var_slot[sep] = np.arange(ns)

    def rnd(x):
        return int(np.ceil(max(x, 1) / pad_multiple) * pad_multiple)

    nd = rnd(max(len(p) for p in parts))
    int_idx, int_mask = _pad_to(parts, nd, n)

    # assign rows to parts: by the part of any interior column; pure-separator
    # rows round-robin
    row_part = np.zeros(m, dtype=np.int64)
    rr = 0
    for i, cols in enumerate(structure.row_cols):
        pids = {int(var_part[c]) for c in cols if var_part[c] >= 0}
        assert len(pids) <= 1, "row spans two part interiors"
        if pids:
            row_part[i] = pids.pop()
        else:
            row_part[i] = rr % P
            rr += 1
    rows_by_part = [np.nonzero(row_part == p)[0] for p in range(P)]
    mr = rnd(max(len(r) for r in rows_by_part))
    rows, rows_mask = _pad_to(rows_by_part, mr, m)

    # Jacobian coloring + local structural masks
    colorJ = color_groups(n, structure.row_cols)
    nJ = int(colorJ.max(initial=-1)) + 1
    Aint_mask = np.zeros((P, mr, nd), dtype=bool)
    Asep_mask = np.zeros((P, mr, ns), dtype=bool)
    for p in range(P):
        for r, gi in enumerate(rows_by_part[p]):
            for c in structure.row_cols[gi]:
                if var_part[c] == p:
                    Aint_mask[p, r, var_slot[c]] = True
                elif var_part[c] < 0:
                    Asep_mask[p, r, var_slot[c]] = True

    # Hessian structural pattern: union of row cliques + obj pairs + diagonal
    colorH = color_groups(
        n, [sorted(adj[i] | {i}) for i in range(n)]
    )
    nH = int(colorH.max(initial=-1)) + 1
    Hpp_mask = np.zeros((P, nd, nd), dtype=bool)
    Hps_mask = np.zeros((P, nd, ns), dtype=bool)
    Hss_mask = np.zeros((ns, ns), dtype=bool)
    sep_set = set(int(s) for s in sep)
    for i in range(n):
        nb = adj[i] | {i}
        pi = var_part[i]
        si = var_slot[i]
        for j in nb:
            pj = var_part[j]
            sj = var_slot[j]
            if pi >= 0 and pj == pi:
                Hpp_mask[pi, si, sj] = True
            elif pi >= 0 and pj < 0:
                Hps_mask[pi, si, sj] = True
            elif pi < 0 and pj < 0:
                Hss_mask[si, sj] = True
            # pi < 0 <= pj handled by the symmetric visit (j, i)

    # equality rows per part, with global dense-eq ordering
    eq_rows_by_part = [
        np.nonzero((row_part == p) & eq_mask)[0] for p in range(P)
    ]
    m_eq = int(eq_mask.sum())
    eq_order = np.concatenate(
        [r for r in eq_rows_by_part] or [np.zeros(0, dtype=np.int64)]
    )
    gidx_of_row = np.full(m, m_eq, dtype=np.int64)
    gidx_of_row[eq_order] = np.arange(m_eq)
    mre = rnd(max((len(r) for r in eq_rows_by_part), default=1))
    eq_rows, eq_rows_mask = _pad_to(eq_rows_by_part, mre, m)
    eq_gidx = np.where(eq_rows_mask, gidx_of_row[np.minimum(eq_rows, m - 1)], m_eq)
    # local row slot of each eq row within its part's padded row list
    eq_local = np.full((P, mre), mr, dtype=np.int64)
    for p in range(P):
        slot_of = {int(r): i for i, r in enumerate(rows_by_part[p])}
        for j, gr in enumerate(eq_rows_by_part[p]):
            eq_local[p, j] = slot_of[int(gr)]

    return BlockStructure(
        n=n, m=m, P=P, nd=nd, ns=ns, mr=mr, mre=mre,
        int_idx=int_idx, int_mask=int_mask, sep_idx=np.asarray(sep),
        var_part=var_part, var_slot=var_slot,
        rows=rows, rows_mask=rows_mask,
        colorJ=colorJ, nJ=nJ, Aint_mask=Aint_mask, Asep_mask=Asep_mask,
        colorH=colorH, nH=nH, Hpp_mask=Hpp_mask, Hps_mask=Hps_mask,
        Hss_mask=Hss_mask,
        eq_rows=eq_rows, eq_rows_mask=eq_rows_mask, eq_gidx=eq_gidx,
        eq_local=eq_local,
        m_eq=m_eq, eq_order=eq_order, is_eq=np.asarray(eq_mask, bool),
    )
