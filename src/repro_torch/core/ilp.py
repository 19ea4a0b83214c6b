"""Exact MUS solver — depth-first branch & bound (CPLEX stand-in) — and the
Lagrangian dual bound of the LP relaxation; the port of ``repro.core.ilp``.

The reference module is already a host algorithm in numpy.  This is a copy
of it, op for op, reading the port's ``us_tensor``/``hard_feasible`` (and
the instance's leaves) as numpy on the host; the searches never touch the
card.  Assignments come back as CPU tensors.

The MUS ILP (Eq. 2) is NP-hard (Theorem 1), so exact solving is reserved for
small instances: it is the oracle behind the paper's "GUS achieves on
average 90% of the optimal" claim (Sec. IV).

Bounding: at each node the remaining requests contribute at most their best
feasible US *ignoring capacity* (an admissible relaxation of 2d/2e), so
``current + optimistic_suffix <= best`` prunes.  Requests are pre-sorted by
their optimistic US descending, which tightens the bound early.
``solve_exhaustive`` enumerates every assignment vector (tests only).

``lagrangian_dual`` / ``lagrangian_bound`` evaluate the Lagrangian dual of
the MUS **LP relaxation** (capacity constraints 2d/2e dualized with
multipliers ``lam``/``mu`` >= 0): every dual point is a certified *upper
bound* on the integral optimum, and subgradient descent tightens it.  It
scales to hundreds of requests, past the ``ilp`` policy's 24-request
refusal; ``price_directed_greedy`` turns the prices into a feasible primal
(the ``lp-bound`` policy).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from .gus import Assignment
from .instance import FlatInstance
from .satisfaction import hard_feasible, us_tensor

__all__ = [
    "solve_bnb",
    "solve_exhaustive",
    "lagrangian_dual",
    "lagrangian_bound",
    "price_directed_greedy",
]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _assignment(out_j: np.ndarray, out_l: np.ndarray) -> Assignment:
    return Assignment(torch.from_numpy(out_j), torch.from_numpy(out_l))


def _prepare(inst: FlatInstance):
    us = _host(us_tensor(inst))
    feas = _host(hard_feasible(inst))
    v = _host(inst.v)
    u = _host(inst.u)
    cover = _host(inst.cover)
    gamma = np.asarray(_host(inst.gamma), dtype=np.float64)
    eta = np.asarray(_host(inst.eta), dtype=np.float64)
    N, M, L = us.shape
    # Per-request candidate list: (us, j, l, v, u_charged) feasibility-filtered,
    # sorted by us descending.
    cands = []
    for i in range(N):
        lst = []
        for j in range(M):
            for l in range(L):
                if feas[i, j, l]:
                    uu = 0.0 if j == cover[i] else float(u[i, j, l])
                    lst.append((float(us[i, j, l]), j, l, float(v[i, j, l]), uu))
        lst.sort(key=lambda t: -t[0])
        cands.append(lst)
    return us, cands, cover, gamma, eta, N


def solve_bnb(
    inst: FlatInstance, *, node_limit: int = 5_000_000, strict: bool = False
) -> Tuple[Assignment, float]:
    """Exact optimum of (2).  Returns (assignment, objective = mean US).

    When the node budget trips, the search stops and the best solution found
    so far is returned (anytime behaviour) — unless ``strict=True``, which
    raises instead, so callers that certify optimality (the optimality-gap
    benchmarks) cannot silently divide by a non-optimal "optimum".
    """
    us, cands, cover, gamma0, eta0, N = _prepare(inst)

    # Sort requests so the ones with the largest optimistic US go first.
    opt_us = np.array([c[0][0] if c else 0.0 for c in cands])
    order = np.argsort(-opt_us)
    # optimistic suffix sums over the *sorted* order
    suffix = np.zeros(N + 1)
    for pos in range(N - 1, -1, -1):
        suffix[pos] = suffix[pos + 1] + max(opt_us[order[pos]], 0.0)

    best_val = -np.inf
    best_assign = [(-1, -1)] * N
    cur_assign = [(-1, -1)] * N
    nodes = 0

    gamma = gamma0.copy()
    eta = eta0.copy()

    def dfs(pos, cur_val):
        nonlocal best_val, best_assign, nodes
        nodes += 1
        if nodes > node_limit:
            return
        if cur_val + suffix[pos] <= best_val + 1e-12:
            return
        if pos == N:
            if cur_val > best_val:
                best_val = cur_val
                best_assign = list(cur_assign)
            return
        i = int(order[pos])
        s_i = int(cover[i])
        for usv, j, l, vv, uu in cands[i]:
            if vv > gamma[j] + 1e-9:
                continue
            if uu > eta[s_i] + 1e-9:
                continue
            gamma[j] -= vv
            eta[s_i] -= uu
            cur_assign[i] = (j, l)
            dfs(pos + 1, cur_val + usv)
            gamma[j] += vv
            eta[s_i] += uu
            cur_assign[i] = (-1, -1)
        # drop branch
        dfs(pos + 1, cur_val)

    dfs(0, 0.0)
    if strict and nodes > node_limit:
        raise RuntimeError(
            f"solve_bnb hit node_limit={node_limit} before exhausting the "
            f"search on a {N}-request instance; the returned value would not "
            "be a certified optimum"
        )
    jv = np.array([a[0] for a in best_assign], np.int32)
    lv = np.array([a[1] for a in best_assign], np.int32)
    return _assignment(jv, lv), float(best_val) / max(N, 1)


def solve_exhaustive(inst: FlatInstance) -> Tuple[Assignment, float]:
    """Brute force over all (M*L + 1)^N assignments.  Tiny instances only."""
    us, cands, cover, gamma0, eta0, N = _prepare(inst)
    options = [c + [None] for c in cands]  # None = drop
    best_val, best = -np.inf, None
    for choice in itertools.product(*options):
        gamma = gamma0.copy()
        eta = eta0.copy()
        val, ok = 0.0, True
        for i, ch in enumerate(choice):
            if ch is None:
                continue
            usv, j, l, vv, uu = ch
            gamma[j] -= vv
            eta[int(cover[i])] -= uu
            if gamma[j] < -1e-9 or eta[int(cover[i])] < -1e-9:
                ok = False
                break
            val += usv
        if ok and val > best_val:
            best_val, best = val, choice
    jv = np.array([(-1 if c is None else c[1]) for c in best], np.int32)
    lv = np.array([(-1 if c is None else c[2]) for c in best], np.int32)
    return _assignment(jv, lv), float(best_val) / N


# ---------------------------------------------------------------------------
# Lagrangian dual of the LP relaxation (scalable upper bound)
# ---------------------------------------------------------------------------


def _dual_arrays(inst: FlatInstance):
    us = np.asarray(_host(us_tensor(inst)), np.float64)
    feas = _host(hard_feasible(inst))
    v = np.asarray(_host(inst.v), np.float64)
    u = np.asarray(_host(inst.u), np.float64)
    cover = _host(inst.cover)
    gamma = np.asarray(_host(inst.gamma), np.float64)
    eta = np.asarray(_host(inst.eta), np.float64)
    N, M, L = us.shape
    local = cover[:, None] == np.arange(M)[None, :]
    u_eff = np.where(local[:, :, None], 0.0, u)  # comm charged only when offloading
    score = np.where(feas, us, -np.inf)
    return score, v, u_eff, cover, gamma, eta, N, M, L


def lagrangian_dual(
    inst: FlatInstance, *, n_iter: int = 120
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Minimize the Lagrangian dual of the MUS LP relaxation by projected
    subgradient descent.  Returns ``(bound, lam, mu)`` where ``bound`` is
    the best (smallest) dual value found, in *mean-US* units — a certified
    upper bound on ``solve_bnb``'s optimum for ANY iterate, since

        D(lam, mu) = lam @ gamma + mu @ eta
                     + sum_i max(0, max_jl [us - lam_j v - mu_{s_i} u])

    dominates every feasible assignment whenever ``lam, mu >= 0``.
    ``lam``/``mu`` are the final multipliers (for price-directed rounding),
    not necessarily the ones attaining ``bound``.
    """
    score, v, u_eff, cover, gamma, eta, N, M, L = _dual_arrays(inst)
    lam = np.zeros(M)
    mu = np.zeros(M)
    best = np.inf
    idx_n = np.arange(N)
    # step length for the normalized direction g/||g||: a diminishing
    # us_scale * N / (||g|| * sqrt(it+1)) — ||g|| is dominated by the
    # capacity terms, so this lands the multipliers in US-per-capacity units
    finite = score[np.isfinite(score)]
    us_scale = float(np.max(finite)) if finite.size else 0.0

    for it in range(n_iter):
        reduced = (
            score
            - lam[None, :, None] * v
            - mu[cover][:, None, None] * u_eff
        )
        flat = reduced.reshape(N, -1)
        pick = np.argmax(flat, axis=1)
        val = flat[idx_n, pick]
        active = val > 0.0  # LP serves request i only if its reduced US is positive
        dual = float(lam @ gamma + mu @ eta + np.sum(np.maximum(val[active], 0.0)))
        best = min(best, dual)

        j_pick, l_pick = np.divmod(pick, L)
        g_lam = gamma.copy()
        g_mu = eta.copy()
        if active.any():
            np.subtract.at(g_lam, j_pick[active], v[idx_n[active], j_pick[active], l_pick[active]])
            np.subtract.at(g_mu, cover[active], u_eff[idx_n[active], j_pick[active], l_pick[active]])
        norm = float(np.sqrt(g_lam @ g_lam + g_mu @ g_mu))
        if norm < 1e-12:
            break
        step = max(us_scale, 1e-6) * N / (norm * np.sqrt(it + 1.0))
        lam = np.maximum(lam - step * g_lam / norm, 0.0)
        mu = np.maximum(mu - step * g_mu / norm, 0.0)
    return best / max(N, 1), lam, mu


def lagrangian_bound(inst: FlatInstance, *, n_iter: int = 120) -> float:
    """Certified upper bound on the MUS optimum (mean-US units); see
    :func:`lagrangian_dual`."""
    bound, _, _ = lagrangian_dual(inst, n_iter=n_iter)
    return bound


def price_directed_greedy(
    inst: FlatInstance, lam: np.ndarray, mu: np.ndarray
) -> Assignment:
    """Feasible primal from dual prices: GUS's sequential greedy, but
    ranking candidates by *reduced* US (``us - lam_j v - mu_{s_i} u``) and
    dropping requests whose best reduced US is non-positive — capacity the
    multipliers already "charge" for is left to later requests.  Honors the
    true capacity constraints, so the result is always feasible."""
    score, v, u_eff, cover, gamma_c, eta_c, N, M, L = _dual_arrays(inst)
    gamma = gamma_c.copy()
    eta = eta_c.copy()
    reduced = score - lam[None, :, None] * v - mu[cover][:, None, None] * u_eff
    out_j = np.full(N, -1, np.int32)
    out_l = np.full(N, -1, np.int32)
    for i in range(N):
        s_i = int(cover[i])
        ok = (
            np.isfinite(reduced[i])
            & (reduced[i] > 0.0)
            & (v[i] <= gamma[:, None] + 1e-9)
            & (((np.arange(M) == s_i)[:, None]) | (u_eff[i] <= eta[s_i] + 1e-9))
        )
        if not ok.any():
            continue
        masked = np.where(ok, reduced[i], -np.inf)
        j, l = np.unravel_index(int(np.argmax(masked)), (M, L))
        out_j[i], out_l[i] = j, l
        gamma[j] -= v[i, j, l]
        if j != s_i:
            eta[s_i] -= u_eff[i, j, l]
    return _assignment(out_j, out_l)
