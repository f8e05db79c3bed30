"""Batched fixed-iteration L-BFGS (two-loop recursion, backtracking line
search over a fixed set of trial steps).

Port of `allocnet_tpu/ops/lbfgs.py` (the reference's lbfgs.hpp, with a
fixed-shape line search).  The JAX module minimizes one problem and is
vmapped over problems; here one call minimizes a batch of independent
problems, each row with its own memory, step and acceptance.  The memory
size and the iteration and trial counts are the same fixed numbers, so
both packages take the same steps.  Gradients come from
`torch.autograd.grad` of the batch's summed cost: the problems are
independent, so each row's gradient is its own.
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(a, b):
    return (a * b).sum(-1)


def minimize(
    fun: Callable,
    x0: torch.Tensor,
    iters: int = 60,
    memory: int = 8,
    ls_steps: int = 12,
    ls_decay: float = 0.5,
    armijo: float = 1e-4,
    init_step: float = 1.0,
):
    """Minimize a batch of problems from x0 (B, n).

    fun maps points (B, K, n) to costs (B, K): K points of each row's
    problem (K = 1 for the value and gradient, K = ls_steps for the line
    search).  Returns (x (B, n), f (B,)).  A failed line search keeps the
    row's iterate, so the routine is total."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device
    rows = torch.arange(B, device=dev)

    def val_grad(x):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            f = fun(xv[:, None])[:, 0]
            g, = torch.autograd.grad(f.sum(), xv)
        return f.detach(), g

    S = torch.zeros((B, memory, n), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    RHO = torch.zeros((B, memory), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def direction(g, S, Y, RHO, k):
        """Two-loop recursion over each row's valid memory entries."""
        q = g
        alphas = torch.zeros((B, memory), dtype=dt, device=dev)
        kv = torch.clamp(k, max=memory)
        for i in range(memory):
            j = (k - 1 - i) % memory
            valid = i < kv
            a = torch.where(valid, RHO[rows, j] * _dot(S[rows, j], q), zero)
            q = q - a[:, None] * Y[rows, j]
            alphas[rows, j] = a

        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        jl = (k - 1) % memory
        yy = _dot(Y[rows, jl], Y[rows, jl])
        sy = _dot(S[rows, jl], Y[rows, jl])
        gamma = torch.where((k > 0) & (yy > 1e-12),
                            sy / yy.clamp_min(1e-12), torch.ones_like(yy))
        r = q * gamma[:, None]
        for i in range(memory):
            j = (k - kv + i) % memory
            beta = RHO[rows, j] * _dot(Y[rows, j], r)
            upd = (alphas[rows, j] - beta)[:, None] * S[rows, j]
            r = r + torch.where((i < kv)[:, None], upd, zero)
        return -r

    ts = init_step * ls_decay ** torch.arange(ls_steps, dtype=dt, device=dev)

    def line_search(x, f, g, d):
        """First Armijo step, else the best strictly decreasing trial."""
        gtd = _dot(g, d)
        # steepest descent where d is not a descent direction
        d = torch.where((gtd < 0)[:, None], d, -g)
        gtd = torch.minimum(gtd, -_dot(g, g))

        fs = fun(x[:, None, :] + ts[None, :, None] * d[:, None, :])
        fs = torch.where(torch.isfinite(fs), fs, torch.full_like(fs,
                                                                 torch.inf))
        armijo_ok = fs <= f[:, None] + armijo * ts[None, :] * gtd[:, None]
        first_ok = torch.argmax(armijo_ok.to(torch.int32), dim=1)
        any_armijo = armijo_ok.any(1)
        best = torch.argmin(fs, dim=1)
        any_decrease = fs[rows, best] < f
        idx = torch.where(any_armijo, first_ok, best)
        found = any_armijo | any_decrease
        t = torch.where(found, ts[idx], zero)
        return t, found, d

    x = x0
    f, g = val_grad(x0)
    k = torch.zeros((B,), dtype=torch.long, device=dev)
    for _ in range(iters):
        d = direction(g, S, Y, RHO, k)
        t, found, d = line_search(x, f, g, d)
        x_new = x + t[:, None] * d
        f_new, g_new = val_grad(x_new)
        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        slot = k % memory
        good = found & (sy > 1e-12)
        S[rows, slot] = torch.where(good[:, None], s, S[rows, slot])
        Y[rows, slot] = torch.where(good[:, None], y, Y[rows, slot])
        RHO[rows, slot] = torch.where(good, 1.0 / sy.clamp_min(1e-12),
                                      RHO[rows, slot])
        k = k + good.long()
        x = torch.where(found[:, None], x_new, x)
        f = torch.where(found, f_new, f)
        g = torch.where(found[:, None], g_new, g)
    return x, f
