"""The port's optimizer stack (``optimize/``) held against the JAX package's
on the reference's own problems (``tests/test_optimize.py``: a quadratic
and a least-squares problem with a forward/loss split), iteration by
iteration; the updaters and the line search step by step; then the
reference's behavioural tests on the port, and the host reads the eager
solvers make."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import LayerConfig as JLayerConfig
from deeplearning4j_tpu.optimize import linesearch as jlinesearch
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu.optimize import updaters as jupdaters
from deeplearning4j_tpu.optimize.api import ModelFunctions as JModelFunctions
from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.nn.conf import LayerConfig, OptimizationAlgorithm
from deeplearning4j_tpu_torch.optimize import Solver, api, linesearch, solvers, updaters
from deeplearning4j_tpu_torch.optimize.api import ModelFunctions, ScoreIterationListener
from deeplearning4j_tpu_torch.utils import tree_math as tm

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

#: per-iteration scores, port vs reference, over the first ITERS
#: iterations: |s - s_ref| <= SCORE_RTOL * max(|s_ref|, SCORE_FLOOR * s_0)
#: (a solver that reaches ~0 leaves f32 rounding as the whole score)
SCORE_RTOL = 1e-4
SCORE_FLOOR = 1e-4
#: final params: ||p - p_ref|| <= PARAM_RTOL * ||p_ref||
PARAM_RTOL = 1e-4
ITERS = 10

A_DIAG = np.array([1.0, 10.0, 0.5, 4.0], np.float32)
C_VEC = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
_RS = np.random.default_rng(1)
X_LSQ = _RS.normal(size=(64, 8)).astype(np.float32)
W_TRUE = _RS.normal(size=(8,)).astype(np.float32)
Y_LSQ = X_LSQ @ W_TRUE


def _quadratic(port: bool):
    if port:
        a, c = torch.diag(torch.from_numpy(A_DIAG)), torch.from_numpy(C_VEC)

        def score(params, key=None):
            d = params["x"] - c
            return 0.5 * d @ a @ d

        return ModelFunctions.from_score(score), {"x": torch.zeros(4)}
    a, c = jnp.diag(jnp.asarray(A_DIAG)), jnp.asarray(C_VEC)

    def jscore(params, key=None):
        d = params["x"] - c
        return 0.5 * d @ a @ d

    return JModelFunctions.from_score(jscore), {"x": jnp.zeros(4)}


def _lsq(port: bool):
    lib = torch if port else jnp
    x = torch.from_numpy(X_LSQ) if port else jnp.asarray(X_LSQ)
    y = torch.from_numpy(Y_LSQ) if port else jnp.asarray(Y_LSQ)

    def forward(params):
        return x @ params["w"]

    def loss_on_outputs(z):
        return 0.5 * lib.mean((z - y) ** 2)

    def score(params, key=None):
        return loss_on_outputs(forward(params))

    mf = ModelFunctions if port else JModelFunctions
    zeros = torch.zeros(8) if port else jnp.zeros(8)
    return (mf.from_score(score, forward=forward,
                          loss_on_outputs=loss_on_outputs), {"w": zeros})


PROBLEMS = {"quadratic": _quadratic, "lsq": _lsq}
ALGOS = [
    OptimizationAlgorithm.GRADIENT_DESCENT,
    OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT,
    OptimizationAlgorithm.CONJUGATE_GRADIENT,
    OptimizationAlgorithm.LBFGS,
    OptimizationAlgorithm.HESSIAN_FREE,
]


def _confs(**kw):
    c = JLayerConfig(**kw)
    return c, LayerConfig.from_json(c.to_json())


#: solver settings: adagrad steps (the line search takes its first trial)
#: and plain steps too long for the stiff directions (it backtracks)
SETTINGS = {"adagrad": dict(lr=0.05, use_adagrad=True, momentum=0.5),
            "long": dict(lr=0.5, use_adagrad=False, momentum=0.0)}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_iterations_match_the_reference(algo, problem, setting):
    """Each solver's first ITERS iterations from the same params and key:
    the scores within SCORE_RTOL, the same accepted steps (the line
    search's trial counts), the params at the end within PARAM_RTOL."""
    jconf, conf = _confs(optimization_algo=algo, num_iterations=ITERS,
                         num_line_search_iterations=8, **SETTINGS[setting])
    jmodel, jparams = PROBLEMS[problem](False)
    model, params = PROBLEMS[problem](True)
    jinit, jstep = jsolvers.make_step(jconf, jmodel, algo)
    jstep = jax.jit(jstep)
    init, step = solvers.make_step(conf, model, algo)
    js = jinit(jparams, jax.random.key(3))
    s = init(params, rng.key_for(3))
    s0 = abs(float(js.score))
    assert abs(s.score.item() - float(js.score)) <= SCORE_RTOL * s0
    for i in range(ITERS):
        js, s = jstep(js), step(s)
        ref = float(js.score)
        assert abs(s.score.item() - ref) <= SCORE_RTOL * max(
            abs(ref), SCORE_FLOOR * s0), (i, s.score.item(), ref)
        assert s.step_size == float(js.step_size), (i, s.step_size,
                                                    float(js.step_size))
        if bool(js.done):
            assert bool(s.done), i
            break
        assert not bool(s.done), i
    for k, v in js.params.items():
        v = np.asarray(v)
        got = s.params[k].numpy()
        assert np.linalg.norm(got - v) <= PARAM_RTOL * np.linalg.norm(v), k


def test_line_search_matches_the_reference_trial_for_trial():
    def jscore(p):
        return jnp.sum(p["x"] ** 2)

    def score(p):
        return torch.sum(p["x"] ** 2)

    for scale, max_it in ((-20.0, 10), (-1.0, 5), (-5.0, 2), (3.0, 4)):
        d = np.array([scale, scale * 0.5], np.float32)
        g = np.array([2.0, 2.0], np.float32)
        ref = jlinesearch.backtrack(jscore, {"x": jnp.ones(2)},
                                    {"x": jnp.asarray(d)},
                                    {"x": jnp.asarray(g)},
                                    max_iterations=max_it)
        got = linesearch.backtrack(score, {"x": torch.ones(2)},
                                   {"x": torch.from_numpy(d)},
                                   {"x": torch.from_numpy(g)},
                                   max_iterations=max_it)
        assert got.n_evals == int(ref.n_evals), scale
        assert got.step == float(ref.step), scale
        assert got.score.item() == pytest.approx(float(ref.score), rel=1e-6)


@pytest.mark.parametrize("kw", [
    dict(use_adagrad=True, lr=0.1, momentum=0.5, momentum_after={2: 0.9}),
    dict(use_adagrad=False, lr=0.3, momentum=0.0, use_regularization=True,
         l2=0.1),
    dict(use_adagrad=True, lr=0.2, reset_adagrad_iterations=2,
         constrain_gradient_to_unit_norm=True),
], ids=["adagrad-momentum", "lr-l2", "reset-unitnorm"])
def test_updater_matches_the_reference(kw):
    jconf, conf = _confs(**kw)
    rs = np.random.default_rng(7)
    p = {"w": rs.normal(size=(3, 4)).astype(np.float32),
         "b": rs.normal(size=(4,)).astype(np.float32)}
    jstate = jupdaters.init(jax.tree.map(jnp.asarray, p))
    state = updaters.init(tm.tree_map(torch.from_numpy, p))
    for it in range(5):
        g = {k: rs.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        jstep, jstate = jupdaters.adjust(jconf, jstate,
                                         jax.tree.map(jnp.asarray, g),
                                         jax.tree.map(jnp.asarray, p),
                                         batch_size=4)
        step, state = updaters.adjust(conf, state,
                                      tm.tree_map(torch.from_numpy, g),
                                      tm.tree_map(torch.from_numpy, p),
                                      batch_size=4)
        for k in p:
            np.testing.assert_allclose(step[k].numpy(), np.asarray(jstep[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{it} {k}")
    assert state.iteration == int(jstate.iteration)


def test_host_reads_are_counted():
    """The eager GD loop reads back its termination test once an iteration
    and its Armijo test once a line-search trial, nothing else."""
    model, params = _quadratic(True)
    conf = LayerConfig(optimization_algo=OptimizationAlgorithm.GRADIENT_DESCENT,
                       num_iterations=6, use_adagrad=False, momentum=0.0,
                       num_line_search_iterations=8)
    trials = []
    real = linesearch.backtrack

    def spy(*a, **kw):
        r = real(*a, **kw)
        trials.append(r.n_evals)
        return r

    linesearch.backtrack = spy
    try:
        api.reset_host_syncs()
        _, _, iters = solvers.optimize(conf, model, params, rng.key_for(0))
    finally:
        linesearch.backtrack = real
    assert api.host_syncs == iters + sum(trials)
    assert len(trials) == iters


# -- the reference's behavioural tests on the port (tests/test_optimize.py) --

@pytest.mark.parametrize("algo", ALGOS)
def test_solvers_minimize_quadratic(algo):
    model, params = _quadratic(True)
    conf = LayerConfig(optimization_algo=algo, num_iterations=150, lr=0.05,
                       use_adagrad=False, momentum=0.0,
                       num_line_search_iterations=8)
    _, score = Solver(conf, model).optimize(params, rng.key_for(0))
    assert score < 0.05, (algo, score)


@pytest.mark.parametrize("algo", [OptimizationAlgorithm.CONJUGATE_GRADIENT,
                                  OptimizationAlgorithm.LBFGS,
                                  OptimizationAlgorithm.HESSIAN_FREE])
def test_second_order_solvers_on_least_squares(algo):
    model, params = _lsq(True)
    conf = LayerConfig(optimization_algo=algo, num_iterations=100,
                       use_adagrad=False, momentum=0.0, lr=0.1,
                       num_line_search_iterations=10)
    out, score = Solver(conf, model).optimize(params, rng.key_for(2))
    assert score < 1e-3, (algo, score)
    assert torch.max(torch.abs(out["w"] - torch.from_numpy(W_TRUE))) < 0.2


def test_hessian_free_converges_fast_on_illconditioned():
    model, params = _quadratic(True)
    conf = LayerConfig(optimization_algo=OptimizationAlgorithm.HESSIAN_FREE,
                       num_iterations=20, use_adagrad=False)
    out, score = Solver(conf, model).optimize(params, rng.key_for(0))
    assert score < 1e-4
    assert torch.allclose(out["x"], torch.from_numpy(C_VEC), atol=0.05)


def test_line_search_backtracks_on_overshoot():
    def score_fn(p):
        return torch.sum(p["x"] ** 2)

    params = {"x": torch.tensor([1.0, 1.0])}
    res = linesearch.backtrack(score_fn, params,
                               {"x": torch.tensor([-20.0, -20.0])},
                               {"x": torch.tensor([2.0, 2.0])},
                               max_iterations=10)
    assert 0 < res.step < 1.0
    assert float(res.score) < score_fn(params)


def test_updater_adagrad_and_momentum_schedule():
    conf = LayerConfig(use_adagrad=True, lr=0.1, momentum=0.5,
                       momentum_after={5: 0.9})
    params = {"w": torch.ones(3)}
    state = updaters.init(params)
    step1, state = updaters.adjust(conf, state, {"w": torch.ones(3)}, params)
    assert torch.allclose(step1["w"], torch.full((3,), 0.1), atol=1e-4)
    assert state.iteration == 1
    assert updaters._momentum_at(conf, 4) == pytest.approx(0.5)
    assert updaters._momentum_at(conf, 5) == pytest.approx(0.9)


def test_updater_unit_norm_constraint():
    conf = LayerConfig(use_adagrad=False, lr=1.0, momentum=0.0,
                       constrain_gradient_to_unit_norm=True)
    params = {"w": torch.zeros(4)}
    step, _ = updaters.adjust(conf, updaters.init(params),
                              {"w": torch.full((4,), 3.0)}, params)
    assert abs(float(tm.norm2(step)) - 1.0) < 1e-5


def test_listeners_receive_scores():
    model, params = _quadratic(True)
    conf = LayerConfig(optimization_algo=OptimizationAlgorithm.GRADIENT_DESCENT,
                       num_iterations=10, use_adagrad=False, momentum=0.0)
    listener = ScoreIterationListener(print_every=100)
    Solver(conf, model, listeners=[listener]).optimize(params, rng.key_for(0))
    assert len(listener.history) > 0
    assert listener.history[-1] <= listener.history[0]


def test_termination_stops_early():
    model, params = _quadratic(True)
    conf = LayerConfig(optimization_algo=OptimizationAlgorithm.HESSIAN_FREE,
                       num_iterations=1000, use_adagrad=False)
    _, score, iters = solvers.optimize(conf, model, params, rng.key_for(0))
    assert iters < 1000
    assert float(score) < 1e-4


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_computes_inside_the_precision_scope(algo):
    """Every forward, loss and score a solve evaluates (Hessian-free's
    Gauss-Newton products through ``torch.func`` too) sees the policy's
    TF32 switches and deterministic cuDNN, not the process's; the process's
    come back after it."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, dnn.allow_tf32, dnn.deterministic)
    inner, _ = _lsq(port=True)
    seen = []

    def spy(fn):
        def run(*args):
            seen.append((mm.allow_tf32, dnn.allow_tf32, dnn.deterministic))
            return fn(*args)
        return run

    model = ModelFunctions.from_score(
        spy(inner.score), forward=spy(inner.forward),
        loss_on_outputs=spy(inner.loss_on_outputs))
    _, conf = _confs(lr=0.05, num_iterations=3, optimization_algo=algo)
    try:
        mm.allow_tf32, dnn.allow_tf32, dnn.deterministic = True, True, False
        solvers.optimize(conf, model, {"w": torch.zeros(8)}, rng.key_for(0))
        assert seen and set(seen) == {(False, False, True)}
        assert (mm.allow_tf32, dnn.allow_tf32, dnn.deterministic) == (
            True, True, False)
    finally:
        mm.allow_tf32, dnn.allow_tf32, dnn.deterministic = prev
