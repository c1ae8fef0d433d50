"""Mission-level task ordering: greedy, branch-and-bound, Hungarian.

Rebuild of the reference TAMP layer's visit-order solvers
(plan_manager/include/plan_manager/plan_manager.hpp:252-432,
branch_and_bound.hpp BranchAndBoundCombined, hungarian.hpp).

Semantics:
  * Tasks are (item_i -> target_i) pairs with a fixed assignment by
    default; the robot starts at `start`, must visit item then its target,
    repeating until all pairs are served.
  * Costs are true path lengths through the map (JPS), not Euclidean --
    pairwise_path_costs builds the (1+2n) x (1+2n) matrix exactly like
    solvePathWithBranchAndBound (:278-302).
  * greedy_order: nearest unvisited item, then nearest unvisited target
    (solvePathWithGreedy :347-432) -- note the reference greedy does NOT
    respect the fixed assignment (it picks the nearest target).
  * branch_and_bound_order: best-first B&B over visit orders with a
    greedy warm start and admissible lower bound (branch_and_bound.hpp).
  * hungarian: O(n^3) assignment (potentials/augmenting-path variant),
    available for non-fixed assignments.

Host-side numpy: mission ordering is not hot (n <= ~16 pairs).
"""
from __future__ import annotations

import heapq
from typing import Callable, Optional

import numpy as np


def pairwise_path_costs(points, path_length_fn: Callable) -> np.ndarray:
    """Symmetric path-cost matrix over a point list.

    path_length_fn(a, b) -> float length or np.inf when unreachable.
    """
    m = len(points)
    D = np.zeros((m, m))
    for i in range(m):
        for j in range(i + 1, m):
            d = path_length_fn(points[i], points[j])
            D[i, j] = D[j, i] = d if np.isfinite(d) else np.inf
    return D


def greedy_order(dists: np.ndarray, n_tasks: int):
    """Greedy item/target interleave; returns the visit order as global
    indices into the (1 + 2n) matrix (items 1..n, targets n+1..2n)."""
    item_visited = [False] * n_tasks
    target_visited = [False] * n_tasks
    order = []
    cur = 0
    cost = 0.0
    for _ in range(n_tasks):
        cands = [(dists[cur, 1 + i], i) for i in range(n_tasks)
                 if not item_visited[i] and np.isfinite(dists[cur, 1 + i])]
        if not cands:
            break
        d, i = min(cands)
        item_visited[i] = True
        order.append(1 + i)
        cost += d
        cur = 1 + i
        cands = [(dists[cur, 1 + n_tasks + j], j) for j in range(n_tasks)
                 if not target_visited[j]
                 and np.isfinite(dists[cur, 1 + n_tasks + j])]
        if not cands:
            break
        d, j = min(cands)
        target_visited[j] = True
        order.append(1 + n_tasks + j)
        cost += d
        cur = 1 + n_tasks + j
    return order, cost


def _greedy_fixed(dists, n_tasks, assignment):
    """Greedy with the fixed item->target assignment (B&B warm start)."""
    cost = 0.0
    cur = 0
    visited = [False] * n_tasks
    path = [0]
    for _ in range(n_tasks):
        cands = [(dists[cur, 1 + i], i) for i in range(n_tasks)
                 if not visited[i]]
        if not cands:
            break
        d, i = min(cands)
        t = 1 + n_tasks + assignment[i]
        cost += d + dists[1 + i, t]
        path += [1 + i, t]
        visited[i] = True
        cur = t
    return cost, path


def branch_and_bound_order(dists: np.ndarray, n_tasks: int,
                           assignment: Optional[list] = None):
    """Best-first B&B over (item, fixed target) pair orders.

    Returns (order, cost) with order as global indices (start omitted).
    """
    if assignment is None:
        assignment = list(range(n_tasks))

    best_cost, best_path = _greedy_fixed(dists, n_tasks, assignment)

    def lower_bound(cur_cost, last, visited_mask):
        remaining = [i for i in range(n_tasks)
                     if not (visited_mask >> i) & 1]
        if not remaining:
            return cur_cost
        b = cur_cost
        # nearest-next-chair + each pair's own leg (admissible)
        b += min(dists[last, 1 + i] for i in remaining)
        for i in remaining:
            b += dists[1 + i, 1 + n_tasks + assignment[i]]
        return b

    # heap items: (lb, counter, cost, last, mask, path)
    counter = 0
    root_lb = lower_bound(0.0, 0, 0)
    heap = [(root_lb, counter, 0.0, 0, 0, [0])]
    while heap:
        lb, _, cost, last, mask, path = heapq.heappop(heap)
        if lb >= best_cost:
            continue
        if mask == (1 << n_tasks) - 1:
            if cost < best_cost:
                best_cost = cost
                best_path = path
            continue
        for i in range(n_tasks):
            if (mask >> i) & 1:
                continue
            ci = 1 + i
            ti = 1 + n_tasks + assignment[i]
            ncost = cost + dists[last, ci] + dists[ci, ti]
            nmask = mask | (1 << i)
            nlb = lower_bound(ncost, ti, nmask)
            if nlb < best_cost:
                counter += 1
                heapq.heappush(heap, (nlb, counter, ncost, ti, nmask,
                                      path + [ci, ti]))
    return best_path[1:], best_cost


def hungarian(cost: np.ndarray):
    """Minimum-cost assignment; returns (assignment, total_cost).

    Potentials + augmenting-path O(n^3) (the same algorithm family as
    hungarian.hpp).  cost: (n, m) with n <= m.
    """
    n, m = cost.shape
    INF = float("inf")
    u = [0.0] * (n + 1)
    v = [0.0] * (m + 1)
    p = [0] * (m + 1)
    way = [0] * (m + 1)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = [INF] * (m + 1)
        used = [False] * (m + 1)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = 0
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1][j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    assignment = [-1] * n
    total = 0.0
    for j in range(1, m + 1):
        if p[j] > 0:
            assignment[p[j] - 1] = j - 1
            total += cost[p[j] - 1][j - 1]
    return assignment, total
