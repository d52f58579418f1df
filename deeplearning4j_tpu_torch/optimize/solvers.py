"""Convex solvers (the JAX package's ``optimize/solvers.py``): line-searched
gradient descent, plain iteration GD, Polak-Ribière conjugate gradient,
L-BFGS and stochastic Hessian-free, minimizing throughout.

The reference compiles each solver's whole loop (gradient adjustment, line
search, update, termination) into one ``lax.while_loop``. The port runs
the same iteration eagerly; keys are split on the host, and every
decision that depends on a device value reads it back through
``api.host_read`` (counted in ``api.host_syncs``): the termination test
once an iteration, the line search's Armijo test once a trial, L-BFGS's
curvature test once an iteration, Hessian-free's CG residual test once a
CG step. The arithmetic, the termination rules and the listeners' view
are the reference's.

Each solver's ``init_state`` and ``step`` run inside
``dtypes.precision()`` (TF32 as the policy says, deterministic cuDNN):
Hessian-free's Gauss-Newton products run their backward through
``torch.func``, outside any layer's or ``value_and_grad``'s scope.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.nn.conf import LayerConfig, OptimizationAlgorithm
from deeplearning4j_tpu_torch.optimize import linesearch, updaters
from deeplearning4j_tpu_torch.optimize.api import ModelFunctions, host_read
from deeplearning4j_tpu_torch.utils import tree_math as tm


class SolverState(NamedTuple):
    params: Any
    updater: updaters.UpdaterState
    extra: Any  # algorithm-specific carry
    score: torch.Tensor
    old_score: torch.Tensor | float
    step_size: float
    key: Any
    iteration: int
    done: torch.Tensor | bool


# -- per-algorithm direction rules -------------------------------------------

def _gd_extra(params):
    return ()


def _gd_direction(conf, extra, adj_grad, raw_grad):
    return tm.neg(adj_grad), ()


def _cg_extra(params):
    # (prev_grad, prev_direction, have_prev)
    return (tm.zeros_like(params), tm.zeros_like(params), False)


def _cg_direction(conf, extra, adj_grad, raw_grad):
    """Polak-Ribière conjugate direction, restarted with steepest descent
    where it is not a descent direction."""
    prev_g, prev_d, have_prev = extra
    g = adj_grad
    if have_prev:
        denominator = tm.vdot(prev_g, prev_g)
        beta = torch.clamp_min(tm.vdot(g, tm.sub(g, prev_g))
                               / torch.clamp_min(denominator, 1e-20), 0.0)
        d = tm.axpy(beta, prev_d, tm.neg(g))
    else:
        d = tm.neg(g)
    descent = tm.vdot(d, g) < 0
    d = tm.where(descent, d, tm.neg(g))
    return d, (g, d, True)


class LBFGSExtra(NamedTuple):
    """The stored (s, y, rho) pairs, oldest first (at most m), and the
    previous iterate and gradient."""

    pairs: list
    prev_p: Any
    prev_g: Any
    have_prev: bool


def _lbfgs_extra_factory(m: int):
    def make(params):
        return LBFGSExtra([], tm.zeros_like(params), tm.zeros_like(params),
                          False)

    return make


def _lbfgs_direction_factory(m: int):
    def direction(conf, extra, adj_grad, raw_grad):
        """Two-loop recursion over the stored pairs."""
        g = adj_grad
        q = g
        alphas = []
        for s_i, y_i, rho_i in reversed(extra.pairs):  # newest -> oldest
            alpha = rho_i * tm.vdot(s_i, q)
            q = tm.axpy(-alpha, y_i, q)
            alphas.append(alpha)
        if extra.pairs:
            s_n, y_n, _ = extra.pairs[-1]
            gamma = tm.vdot(s_n, y_n) / torch.clamp_min(tm.vdot(y_n, y_n),
                                                        1e-20)
        else:
            gamma = 1.0
        z = tm.scale(q, gamma)
        for (s_i, y_i, rho_i), alpha in zip(extra.pairs, reversed(alphas)):
            beta = rho_i * tm.vdot(y_i, z)
            z = tm.add(z, tm.scale(s_i, alpha - beta))
        d = tm.neg(z)
        descent = tm.vdot(d, g) < 0
        return tm.where(descent, d, tm.neg(g)), extra

    return direction


def _lbfgs_post_factory(m: int):
    def post(extra, new_params, new_raw_grad):
        pairs = extra.pairs
        if extra.have_prev:
            s = tm.sub(new_params, extra.prev_p)
            y = tm.sub(new_raw_grad, extra.prev_g)
            sy = tm.vdot(s, y)
            if host_read(sy > 1e-10):
                pairs = [*pairs, (s, y, 1.0 / torch.clamp_min(sy, 1e-20))][-m:]
        return LBFGSExtra(pairs, new_params, new_raw_grad, True)

    return post


_ALGOS = {
    OptimizationAlgorithm.GRADIENT_DESCENT: (_gd_extra, _gd_direction, None, True),
    OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT: (
        _gd_extra, _gd_direction, None, False),
    OptimizationAlgorithm.CONJUGATE_GRADIENT: (_cg_extra, _cg_direction, None, True),
}
_LBFGS_M = 10
_ALGOS[OptimizationAlgorithm.LBFGS] = (
    _lbfgs_extra_factory(_LBFGS_M),
    _lbfgs_direction_factory(_LBFGS_M),
    _lbfgs_post_factory(_LBFGS_M),
    True,
)


def _converged(score, new_score):
    improvement = torch.abs(score - new_score)
    return improvement < 1e-6 * (torch.abs(score) + torch.abs(new_score)
                                 + 1e-10)


def _scoped(fn):
    """``fn`` run inside ``dtypes.precision()``."""

    def run(*args):
        with dtypes.precision():
            return fn(*args)

    return run


def make_step(conf: LayerConfig, model: ModelFunctions, algo: str | None = None):
    """``(init_state, step)`` for one solver iteration, each run inside
    ``dtypes.precision()``."""
    algo = algo or conf.optimization_algo
    if algo == OptimizationAlgorithm.HESSIAN_FREE:
        init_state, step = _make_hf_step(conf, model)
    else:
        init_state, step = _make_first_order_step(conf, model, algo)
    return _scoped(init_state), _scoped(step)


def _make_first_order_step(conf: LayerConfig, model: ModelFunctions,
                           algo: str):
    if algo not in _ALGOS:
        raise ValueError(f"Unknown optimization algorithm {algo!r}")
    make_extra, direction_fn, post_fn, use_line_search = _ALGOS[algo]

    def init_state(params, key) -> SolverState:
        k0, key = rng.split(key)
        return SolverState(
            params=params, updater=updaters.init(params),
            extra=make_extra(params), score=model.score(params, k0),
            old_score=float("inf"), step_size=1.0, key=key, iteration=0,
            done=False)

    def step(state: SolverState) -> SolverState:
        key, k_grad, k_score = rng.split(state.key, 3)
        score, raw_grad = model.score_and_grad(state.params, k_grad)
        adj_grad, updater = updaters.adjust(conf, state.updater, raw_grad,
                                            state.params)
        direction, extra = direction_fn(conf, state.extra, adj_grad, raw_grad)

        if use_line_search:
            result = linesearch.backtrack(
                lambda p: model.score(p, k_score), state.params, direction,
                raw_grad, initial_step=1.0,
                max_iterations=conf.num_line_search_iterations)
            step_size = result.step
            new_params = tm.axpy(step_size, direction, state.params)
            new_score = result.score
        else:
            step_size = 1.0
            new_params = tm.add(state.params, direction)
            new_score = model.score(new_params, k_score)

        if post_fn is not None:
            # the curvature pair g(new) - g(old) wants correlated sampling,
            # so the second evaluation reuses k_grad on purpose
            _, new_raw_grad = model.score_and_grad(new_params, k_grad)  # lint: prng-ok correlated on purpose
            extra = post_fn(extra, new_params, new_raw_grad)

        done = _converged(score, new_score) | (tm.norm2(raw_grad) < 1e-8)
        return SolverState(
            params=new_params, updater=updater, extra=extra, score=new_score,
            old_score=score, step_size=step_size, key=key,
            iteration=state.iteration + 1, done=done)

    return init_state, step


# -- Hessian-free ------------------------------------------------------------

class HFExtra(NamedTuple):
    damping: torch.Tensor
    x0: Any  # CG warm start


def _gvp_fn(model: ModelFunctions, params):
    """Gauss-Newton vector product v -> J'H_L J v at ``params``: a jvp
    through the forward, the loss's Hessian on the outputs (a jvp of its
    gradient), a vjp back (``torch.func``). Without a forward/loss split,
    the full Hessian-vector product of the score."""
    if model.forward is not None and model.loss_on_outputs is not None:
        z, vjp_from_z = torch.func.vjp(model.forward, params)
        loss_grad = torch.func.grad(model.loss_on_outputs)

        def gvp(v):
            _, z_dot = torch.func.jvp(model.forward, (params,), (v,))
            _, hz = torch.func.jvp(loss_grad, (z,), (z_dot,))
            return vjp_from_z(hz)[0]

        return gvp

    key = rng.key_for(0)
    score_grad = torch.func.grad(lambda p: model.score(p, key))

    def hvp(v):
        return torch.func.jvp(score_grad, (params,), (v,))[1]

    return hvp


def _cg_solve(matvec, b, x0, max_iters: int = 50, tol: float = 1e-5):
    """Conjugate-gradient solve of matvec(x) = b; the residual test is read
    back once a step."""
    r = tm.sub(b, matvec(x0))
    x, p, rs, it = x0, r, tm.vdot(r, r), 0
    while it < max_iters and host_read(rs > tol * tol):
        ap = matvec(p)
        alpha = rs / torch.clamp_min(tm.vdot(p, ap), 1e-20)
        x = tm.axpy(alpha, p, x)
        r = tm.axpy(-alpha, ap, r)
        rs_new = tm.vdot(r, r)
        p = tm.axpy(rs_new / torch.clamp_min(rs, 1e-20), p, r)
        rs, it = rs_new, it + 1
    return x


def _make_hf_step(conf: LayerConfig, model: ModelFunctions):
    """Stochastic Hessian-free (Martens): CG on damped Gauss-Newton
    products with Levenberg-Marquardt damping and a line-searched update."""

    def init_state(params, key) -> SolverState:
        k0, key = rng.split(key)
        score = model.score(params, k0)
        damping = torch.full((), getattr(conf, "damping", 10.0),
                             dtype=torch.float32, device=score.device)
        return SolverState(
            params=params, updater=updaters.init(params),
            extra=HFExtra(damping=damping, x0=tm.zeros_like(params)),
            score=score, old_score=float("inf"), step_size=1.0, key=key,
            iteration=0, done=False)

    def step(state: SolverState) -> SolverState:
        key, k_grad, k_score = rng.split(state.key, 3)
        score, grad = model.score_and_grad(state.params, k_grad)
        lam = state.extra.damping
        gvp = _gvp_fn(model, state.params)

        def damped(v):
            return tm.axpy(lam, v, gvp(v))

        delta = _cg_solve(damped, tm.neg(grad), state.extra.x0)
        # quadratic-model reduction for the LM ratio
        q_red = -(tm.vdot(grad, delta) + 0.5 * tm.vdot(delta, damped(delta)))
        result = linesearch.backtrack(
            lambda p: model.score(p, k_score), state.params, delta, grad,
            initial_step=1.0, max_iterations=conf.num_line_search_iterations)
        new_params = tm.axpy(result.step, delta, state.params)
        new_score = result.score

        rho = (score - new_score) / torch.clamp_min(q_red, 1e-20)
        lam = torch.where(rho > 0.75, lam * (2.0 / 3.0), lam)
        lam = torch.where(rho < 0.25, lam * 1.5, lam)
        return SolverState(
            params=new_params, updater=state.updater,
            extra=HFExtra(damping=lam, x0=tm.scale(delta, 0.95)),
            score=new_score, old_score=score, step_size=result.step, key=key,
            iteration=state.iteration + 1,
            done=_converged(score, new_score))

    return init_state, step


def optimize(conf: LayerConfig, model: ModelFunctions, params, key,
             num_iterations: int | None = None, algo: str | None = None,
             listeners=()):
    """Run the solver until its termination test fires or ``num_iterations``
    (the config's by default) have run. Returns ``(params, final_score,
    iterations_run)``. With ``listeners`` each gets the reference's
    ``{"iteration", "score", "old_score", "step_size"}`` after every
    iteration."""
    n = num_iterations or conf.num_iterations
    init_state, step = make_step(conf, model, algo)
    state = init_state(params, key)
    for i in range(n):
        state = step(state)
        if listeners:
            info = {"iteration": i, "score": host_read(state.score),
                    "old_score": host_read(state.old_score),
                    "step_size": state.step_size}
            for listener in listeners:
                listener.iteration_done(info)
        if host_read(state.done):
            break
    return state.params, state.score, state.iteration
