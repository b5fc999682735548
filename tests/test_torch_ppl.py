"""The port's ``ppl`` front end against the JAX package's, on the same
numpy inputs (``tests/test_ppl.py`` of the JAX package, mirrored: one
port test for each of its tests, under the same class and test names).

- Distributions: ``log_prob`` against scipy and against the JAX
  distributions in float32 (rtol 1e-6) and float64 (rtol 1e-12).
- Handlers: the port's traces against the JAX handlers' traces — site
  order, plate frames, scale, observed flags, substituted values — and
  the JAX package's error texts.
- The compiler: ``log_density``, ``compile(...).logp_and_grad`` and
  ``logp_indices`` against JAX ``ppl.log_density`` and
  ``jax.value_and_grad`` of it (under ``force_subsample`` for index
  batches), on the dense, mesh (8 CPU slots), pool (real TCP nodes
  serving the port's ``node_compute``) and mixed lanes, at float32
  rounding (values rtol 1e-5, gradients rtol 1e-4 atol 1e-5: the JAX
  tests' tolerances); ``torch.func.vmap(compiled.logp)`` against the
  per-point calls.
- The radon model at 8 and 16 counties against JAX ``log_density`` and
  its gradient at 3 seeded points, and against the port's hand-written
  ``HierarchicalRadonGLM``.
- Where the installed JAX can trace the JAX package's ``fed_map`` (it
  lacks ``jax.interpreters.partial_eval.convert_constvars_jaxpr`` from
  JAX 0.9.0 on), the port is also held against the JAX
  ``CompiledModel`` itself; elsewhere those tests skip with that reason.
"""

import itertools
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from jax.interpreters import partial_eval as jax_pe

from pytensor_federated_tpu import ppl as jppl
from pytensor_federated_tpu.ppl import distributions as jdist
from pytensor_federated_torch import fed, ppl
from pytensor_federated_torch.convert import params_from_jax
from pytensor_federated_torch.parallel import make_mesh
from pytensor_federated_torch.ppl import PPLError
from pytensor_federated_torch.ppl.distributions import (
    Bernoulli,
    Exponential,
    HalfNormal,
    HalfNormalLog,
    Normal,
)
from pytensor_federated_torch.routing import NodePool, PooledArraysClient
from pytensor_federated_torch.service import TcpArraysClient, serve_tcp_once

CPU = torch.device("cpu")
RTOL = 1e-5  # float32 values: identical math, differing reduction orders
GTOL, GATOL = 1e-4, 1e-5  # float32 gradients (the JAX tests' tolerances)
F64 = 1e-12
TIMEOUT_S = 60.0
JAX_FED = hasattr(jax_pe, "convert_constvars_jaxpr")
NEEDS_JAX_FED = pytest.mark.skipif(not JAX_FED, reason=(
    "the installed JAX cannot trace the JAX package's fed_map "
    "(jax.interpreters.partial_eval.convert_constvars_jaxpr is gone from "
    "JAX 0.9.0 on), so its ppl.compile cannot run here"))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_model(p, N):
    """``tests/test_ppl.py``'s tiny model, written against ``p`` (either
    package's ``ppl``) and ``N`` (its ``Normal``)."""

    def tiny_model(x):
        w = p.sample("w", N(0.0, 1.0))
        with p.plate("shards", x.shape[0]) as sh:
            b = p.sample("b", N(0.0, 1.0))
            xs = p.subsample(x, sh)
            p.sample("obs", N(w + b[:, None], 1.0), obs=xs)

    return tiny_model


tiny_model = _tiny_model(ppl, Normal)
jtiny_model = _tiny_model(jppl, jdist.Normal)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def tiny_np():
    return np.arange(12.0, dtype=np.float32).reshape(4, 3)


@pytest.fixture(scope="module")
def tiny_data(tiny_np):
    return torch.as_tensor(tiny_np)


@pytest.fixture(scope="module")
def tiny_params_np():
    rng = np.random.default_rng(1)
    return {"w": np.float32(rng.normal()), "b": rng.normal(size=4).astype(np.float32)}


@pytest.fixture(scope="module")
def tiny_params(tiny_params_np):
    return params_from_jax(tiny_params_np, device="cpu")


def _jax_value_and_grad(model, args_np, params_np, *, x64=False, force=None):
    """JAX ``log_density`` and its ``jax.value_and_grad`` at the given
    numpy inputs (under ``force_subsample(force, scale=True)`` if
    given)."""
    with jax.enable_x64(x64):
        args = tuple(jnp.asarray(a) for a in args_np)
        params = {k: jnp.asarray(v) for k, v in params_np.items()}

        def f(p):
            if force is None:
                return jppl.log_density(model, args, p)
            with jppl.force_subsample(indices={k: jnp.asarray(v) for k, v in force.items()}):
                return jppl.log_density(model, args, p)

        v, g = jax.value_and_grad(f)(params)
        return float(v), {k: np.asarray(t) for k, t in g.items()}


def _close(v, g, want_v, want_g, rtol=RTOL, gtol=GTOL, gatol=GATOL):
    np.testing.assert_allclose(float(v), want_v, rtol=rtol)
    assert set(g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(g[k].detach().cpu().numpy(), want_g[k], rtol=gtol, atol=gatol,
                                   err_msg=k)


def _trace_summary(tr):
    """A trace's structure as plain values: per site its type, observed
    flag, scale, plate frames and value."""
    out = {}
    for name, site in tr.items():
        out[name] = (
            site["type"], bool(site["observed"]), float(site["scale"]),
            [(f.name, f.size, f.effective) for f in site["plates"]],
            np.asarray(site["value"].detach() if torch.is_tensor(site["value"]) else site["value"]),
        )
    return out


def _same_structure(a, b, *, values=True):
    assert list(a) == list(b)
    for name in a:
        assert a[name][:4] == b[name][:4], name
        assert a[name][4].shape == b[name][4].shape, name
        if values:
            np.testing.assert_allclose(a[name][4], b[name][4], rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


def _against(dist_t, dist_j, x, want):
    """``log_prob`` against scipy's ``want`` and against the JAX
    distribution in float32 and float64."""
    got = dist_t.log_prob(torch.as_tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(dist_j.log_prob(jnp.asarray(x, jnp.float32))),
                               rtol=1e-6)
    got64 = dist_t.log_prob(torch.as_tensor(x, dtype=torch.float64)).numpy()
    with jax.enable_x64(True):
        want64 = np.asarray(dist_j.log_prob(jnp.asarray(x, jnp.float64)))
    np.testing.assert_allclose(got64, want64, rtol=F64)
    np.testing.assert_allclose(got64, want, rtol=1e-10)


class TestDistributions:
    def test_normal_matches_scipy(self):
        x = np.linspace(-3, 3, 7)
        _against(Normal(0.5, 2.0), jdist.Normal(0.5, 2.0), x,
                 scipy.stats.norm.logpdf(x, 0.5, 2.0))

    def test_halfnormal_matches_scipy(self):
        x = np.linspace(0.1, 4.0, 7)
        _against(HalfNormal(1.5), jdist.HalfNormal(1.5), x,
                 scipy.stats.halfnorm.logpdf(x, scale=1.5))

    def test_halfnormal_log_change_of_variables(self):
        # density of u = log x is halfnorm.pdf(e^u) * e^u
        u = np.linspace(-2.0, 1.0, 7)
        _against(HalfNormalLog(1.0), jdist.HalfNormalLog(1.0), u,
                 scipy.stats.halfnorm.logpdf(np.exp(u)) + u)

    def test_exponential_matches_scipy(self):
        x = np.linspace(0.1, 5.0, 7)
        _against(Exponential(0.7), jdist.Exponential(0.7), x,
                 scipy.stats.expon.logpdf(x, scale=1 / 0.7))

    def test_bernoulli_matches_scipy(self):
        logits = 0.8
        p = 1 / (1 + math.exp(-logits))
        for y in (0.0, 1.0):
            got = float(Bernoulli(logits).log_prob(y))
            np.testing.assert_allclose(got, scipy.stats.bernoulli.logpmf(int(y), p), rtol=1e-6)
            np.testing.assert_allclose(got, float(jdist.Bernoulli(logits).log_prob(y)), rtol=1e-6)
        # tensor logits, float64
        lg = np.linspace(-3.0, 3.0, 5)
        got64 = Bernoulli(torch.as_tensor(lg)).log_prob(torch.ones(5, dtype=torch.float64))
        with jax.enable_x64(True):
            want64 = jdist.Bernoulli(jnp.asarray(lg)).log_prob(jnp.ones(5))
        np.testing.assert_allclose(got64.numpy(), np.asarray(want64), rtol=F64)

    def test_sample_shapes(self):
        g = _gen(0)
        assert Normal(0.0, 1.0).sample(g, (5,)).shape == (5,)
        assert Normal(torch.zeros(3), 1.0).sample(g, (5,)).shape == (5, 3)
        assert HalfNormal(1.0).sample(g, (4,)).shape == (4,)
        assert float(torch.min(HalfNormal(1.0).sample(g, (100,)))) > 0
        assert Exponential(2.0).sample(g, (6,)).shape == (6,)
        b = Bernoulli(torch.zeros(2)).sample(g, (3,))
        assert b.shape == (3, 2) and set(b.unique().tolist()) <= {0.0, 1.0}
        # the draws follow the generator: same state, same draws
        assert torch.equal(Normal(1.0, 2.0).sample(_gen(4), (8,)),
                           Normal(1.0, 2.0).sample(_gen(4), (8,)))
        # the port's and the JAX package's shapes agree
        key = jax.random.PRNGKey(0)
        for dt, dj in ((Normal(torch.zeros(3), 1.0), jdist.Normal(jnp.zeros(3), 1.0)),
                       (HalfNormalLog(1.0), jdist.HalfNormalLog(1.0))):
            assert tuple(dt.sample(g, (2,)).shape) == tuple(dj.sample(key, (2,)).shape)


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the text is compared
        return type(e).__name__, str(e)
    return None


class TestHandlers:
    def test_sample_outside_handlers_is_loud(self):
        with pytest.raises(PPLError, match="outside any handler"):
            ppl.sample("w", Normal())
        assert _error(lambda: ppl.sample("w", Normal())) == _error(
            lambda: jppl.sample("w", jdist.Normal()))

    def test_trace_records_in_order(self, tiny_data, tiny_np):
        tr = ppl.trace(ppl.seed(tiny_model, rng_key=_gen(0))).get_trace(tiny_data)
        assert list(tr) == ["w", "b", "obs"]
        assert tr["obs"]["observed"] and not tr["w"]["observed"]
        assert tr["b"]["value"].shape == (4,)
        jtr = jppl.trace(jppl.seed(jtiny_model, rng_key=jax.random.PRNGKey(0))).get_trace(
            jnp.asarray(tiny_np))
        _same_structure(_trace_summary(tr), _trace_summary(jtr), values=False)
        np.testing.assert_array_equal(tr["obs"]["value"].numpy(), np.asarray(jtr["obs"]["value"]))

    def test_duplicate_site_is_loud(self):
        def bad():
            ppl.sample("w", Normal())
            ppl.sample("w", Normal())

        def jbad():
            jppl.sample("w", jdist.Normal())
            jppl.sample("w", jdist.Normal())

        with pytest.raises(PPLError, match="duplicate site"):
            ppl.trace(ppl.seed(bad, rng_key=_gen(0))).get_trace()
        assert _error(lambda: ppl.trace(ppl.seed(bad, rng_key=_gen(0))).get_trace()) == _error(
            lambda: jppl.trace(jppl.seed(jbad, rng_key=jax.random.PRNGKey(0))).get_trace())

    def test_seeded_trace_determinism(self, tiny_data):
        def draw(gen, **kw):
            tr = ppl.trace(ppl.seed(tiny_model, rng_key=gen, **kw)).get_trace(tiny_data)
            return {k: v["value"].clone() for k, v in tr.items()}

        a, b, c = draw(_gen(7)), draw(_gen(7)), draw(_gen(8))
        for k in a:
            assert torch.equal(a[k], b[k])
        assert not torch.allclose(a["w"], c["w"])
        # an int seed is a generator seeded with it; the handler is
        # reentrant and never advances the caller's generator
        d = draw(7, device="cpu")
        for k in a:
            assert torch.equal(a[k], d[k])
        g = _gen(7)
        state = g.get_state()
        handler = ppl.seed(tiny_model, rng_key=g)
        first = ppl.trace(handler).get_trace(tiny_data)["b"]["value"]
        second = ppl.trace(handler).get_trace(tiny_data)["b"]["value"]
        assert torch.equal(first, second) and torch.equal(g.get_state(), state)

    def test_replay_reproduces_draws(self, tiny_data):
        guide = ppl.trace(ppl.seed(tiny_model, rng_key=_gen(3))).get_trace(tiny_data)
        replayed = ppl.trace(
            ppl.replay(ppl.seed(tiny_model, rng_key=_gen(99)), guide_trace=guide)
        ).get_trace(tiny_data)
        assert torch.equal(replayed["b"]["value"], guide["b"]["value"])
        assert torch.equal(replayed["w"]["value"], guide["w"]["value"])

    def test_condition_marks_observed_substitute_does_not(self):
        for p, N in ((ppl, Normal), (jppl, jdist.Normal)):
            def m():
                p.sample("z", N())

            tr = p.trace(p.condition(m, data={"z": 1.5})).get_trace()
            assert tr["z"]["observed"] and float(tr["z"]["value"]) == 1.5
            tr = p.trace(p.substitute(m, data={"z": 2.5})).get_trace()
            assert not tr["z"]["observed"]
            assert float(tr["z"]["value"]) == 2.5

    def test_condition_vs_substitute_innermost_wins(self):
        """Precedence is purely positional: the INNER handler takes the
        site, whichever kind it is — in both packages."""
        got = {}
        for p, N in ((ppl, Normal), (jppl, jdist.Normal)):
            def m():
                p.sample("z", N())

            a = p.trace(p.condition(p.substitute(m, data={"z": 2.0}), data={"z": 1.0})).get_trace()
            b = p.trace(p.substitute(p.condition(m, data={"z": 1.0}), data={"z": 2.0})).get_trace()
            got[p] = [(float(t["z"]["value"]), bool(t["z"]["observed"])) for t in (a, b)]
        assert got[ppl] == got[jppl] == [(2.0, False), (1.0, True)]

    def test_obs_beats_every_handler(self):
        def m():
            ppl.sample("z", Normal(), obs=7.0)

        def jm():
            jppl.sample("z", jdist.Normal(), obs=7.0)

        tr = ppl.trace(ppl.substitute(m, data={"z": 1.0})).get_trace()
        assert float(tr["z"]["value"]) == 7.0
        assert tr["z"]["observed"]
        jtr = jppl.trace(jppl.substitute(jm, data={"z": 1.0})).get_trace()
        _same_structure(_trace_summary(tr), _trace_summary(jtr))

    def test_block_hides_from_outer_trace(self, tiny_data, tiny_np):
        inner = ppl.seed(tiny_model, rng_key=_gen(0))
        tr = ppl.trace(ppl.block(inner, hide=["b"])).get_trace(tiny_data)
        assert "b" not in tr and "w" in tr
        tr = ppl.trace(ppl.block(inner)).get_trace(tiny_data)
        assert not tr  # everything hidden
        jinner = jppl.seed(jtiny_model, rng_key=jax.random.PRNGKey(0))
        jtr = jppl.trace(jppl.block(jinner, hide=["b"])).get_trace(jnp.asarray(tiny_np))
        tr = ppl.trace(ppl.block(inner, hide_fn=lambda msg: msg["name"] == "b")).get_trace(
            tiny_data)
        assert list(tr) == list(jtr) == ["w", "obs"]

    def test_missing_latent_is_loud(self, tiny_data, tiny_np):
        with pytest.raises(PPLError, match="'b'"):
            ppl.log_density(tiny_model, (tiny_data,), {"w": torch.zeros(())})
        assert _error(lambda: ppl.log_density(tiny_model, (tiny_data,), {"w": torch.zeros(())})) \
            == _error(lambda: jppl.log_density(jtiny_model, (jnp.asarray(tiny_np),),
                                               {"w": jnp.zeros(())}))

    def test_nested_plates(self):
        def m_of(p, N):
            def m(y):
                with p.plate("outer", 3):
                    with p.plate("inner", 2):
                        z = p.sample("z", N())
                        p.sample("obs", N(z, 1.0), obs=y)
            return m

        m, jm = m_of(ppl, Normal), m_of(jppl, jdist.Normal)
        y = torch.zeros((3, 2))
        tr = ppl.trace(ppl.seed(m, rng_key=_gen(0))).get_trace(y)
        # nested draws stack the plate axes outermost-first
        assert tr["z"]["value"].shape == (3, 2)
        assert [f.name for f in tr["z"]["plates"]] == ["outer", "inner"]
        jtr = jppl.trace(jppl.seed(jm, rng_key=jax.random.PRNGKey(0))).get_trace(jnp.zeros((3, 2)))
        _same_structure(_trace_summary(tr), _trace_summary(jtr), values=False)
        # the density matches the hand-written sum and the JAX package's
        params = {"z": tr["z"]["value"]}
        lp = ppl.log_density(m, (y,), params)
        z = params["z"].numpy()
        want = np.sum(scipy.stats.norm.logpdf(z)) + np.sum(scipy.stats.norm.logpdf(0.0, z, 1.0))
        np.testing.assert_allclose(float(lp), want, rtol=1e-5)
        v, _ = _jax_value_and_grad(jm, (np.zeros((3, 2), np.float32),), {"z": z})
        np.testing.assert_allclose(float(lp), v, rtol=1e-6)

    def test_subsample_outside_plate_is_loud(self):
        def m(x):
            ppl.subsample(x)

        with pytest.raises(PPLError, match="outside any active plate"):
            ppl.trace(m).get_trace(torch.zeros((3,)))

    def test_plate_subsample_scales_and_slices(self):
        """An author-declared subsample_size draws indices under seed,
        slices data through subsample(), and scales site terms — as the
        JAX handlers do (the drawn indices differ: the port draws a
        ``torch.randperm`` prefix)."""

        def m_of(p, N):
            def m(y):
                with p.plate("n", 6, subsample_size=2) as pl:
                    ys = p.subsample(y, pl)
                    p.sample("obs", N(0.0, 1.0), obs=ys)
            return m

        y = np.arange(6.0, dtype=np.float32)
        tr = ppl.trace(ppl.seed(m_of(ppl, Normal), rng_key=_gen(0))).get_trace(torch.as_tensor(y))
        jtr = jppl.trace(jppl.seed(m_of(jppl, jdist.Normal), rng_key=jax.random.PRNGKey(0))
                         ).get_trace(jnp.asarray(y))
        site = tr["obs"]
        assert site["value"].shape == (2,)
        assert site["scale"] == pytest.approx(3.0)
        assert site["plates"][0].effective == 2
        _same_structure(_trace_summary(tr), _trace_summary(jtr), values=False)
        # the two drawn values are distinct rows of y (without replacement)
        vals = site["value"].tolist()
        assert len(set(vals)) == 2 and set(vals) <= set(y.tolist())
        with pytest.raises(PPLError, match="no seed handler"):
            ppl.trace(m_of(ppl, Normal)).get_trace(torch.as_tensor(y))


# ---------------------------------------------------------------------------
# compiler: parity + unbiasedness
# ---------------------------------------------------------------------------


class TestCompile:
    def test_logp_matches_direct(self, tiny_data, tiny_params, tiny_np, tiny_params_np):
        c = ppl.compile(tiny_model, (tiny_data,))
        direct = ppl.log_density(tiny_model, (tiny_data,), tiny_params)
        np.testing.assert_allclose(float(c.logp(tiny_params)), float(direct), rtol=1e-6)
        v, _ = _jax_value_and_grad(jtiny_model, (tiny_np,), tiny_params_np)
        np.testing.assert_allclose(float(c.logp(tiny_params)), v, rtol=RTOL)
        np.testing.assert_allclose(float(direct), v, rtol=RTOL)

    def test_grad_matches_direct(self, tiny_data, tiny_params, tiny_np, tiny_params_np):
        c = ppl.compile(tiny_model, (tiny_data,))
        v, g = c.logp_and_grad(tiny_params)
        _close(v, g, *_jax_value_and_grad(jtiny_model, (tiny_np,), tiny_params_np))
        # and in float64, against JAX under x64
        params64 = {k: t.double() for k, t in tiny_params.items()}
        c64 = ppl.compile(tiny_model, (tiny_data.double(),))
        v64, g64 = c64.logp_and_grad(params64)
        np64 = {k: np.float64(v) if np.ndim(v) == 0 else v.astype(np.float64)
                for k, v in tiny_params_np.items()}
        _close(v64, g64, *_jax_value_and_grad(jtiny_model, (tiny_np.astype(np.float64),), np64,
                                              x64=True), rtol=F64, gtol=1e-10, gatol=1e-12)

    def test_full_index_batch_equals_logp(self, tiny_data, tiny_params):
        c = ppl.compile(tiny_model, (tiny_data,))
        np.testing.assert_allclose(float(c.logp_indices(tiny_params, torch.arange(4))),
                                   float(c.logp(tiny_params)), rtol=1e-6)

    def test_subsample_unbiasedness_exact(self, tiny_data, tiny_params):
        """E over ALL (S choose m) index sets of the scaled minibatch
        logp == the full-data logp, exactly (a linear identity)."""
        c = ppl.compile(tiny_model, (tiny_data,))
        full = float(c.logp(tiny_params))
        for m in (1, 2, 3):
            vals = [float(c.logp_indices(tiny_params, torch.as_tensor(idx)))
                    for idx in itertools.combinations(range(4), m)]
            np.testing.assert_allclose(np.mean(vals), full, rtol=1e-5)

    def test_minibatch_draws_without_replacement(self, tiny_data, tiny_params):
        c = ppl.compile(tiny_model, (tiny_data,))
        v = c.logp_minibatch(tiny_params, _gen(0), batch_size=4)
        # batch == plate -> scale 1 -> exactly the full logp
        np.testing.assert_allclose(float(v), float(c.logp(tiny_params)), rtol=1e-6)
        # a smaller batch equals logp_indices at the generator's randperm prefix
        idx = torch.randperm(4, generator=_gen(5))[:2]
        np.testing.assert_allclose(float(c.logp_minibatch(tiny_params, _gen(5), batch_size=2)),
                                   float(c.logp_indices(tiny_params, idx)), rtol=0)
        with pytest.raises(PPLError, match="no batch size"):
            c.logp_minibatch(tiny_params, _gen(0))

    def test_no_plate_is_loud(self):
        def m():
            ppl.sample("z", Normal())

        with pytest.raises(PPLError, match="outermost plate"):
            ppl.compile(m, (), device="cpu")

    def test_params_structure_mismatch_is_loud(self, tiny_data, tiny_params):
        c = ppl.compile(tiny_model, (tiny_data,))
        with pytest.raises(PPLError, match="structure mismatch"):
            c.logp({"w": torch.zeros(())})

    def test_nested_plate_model_compiles_on_outer(self):
        def m_of(p, N):
            def m(y):
                w = p.sample("w", N())
                with p.plate("outer", 4) as po:
                    ys = p.subsample(y, po)
                    with p.plate("inner", 2):
                        z = p.sample("z", N())
                        p.sample("obs", N(w + z, 1.0), obs=ys)
            return m

        y = np.arange(8.0, dtype=np.float32).reshape(4, 2)
        m = m_of(ppl, Normal)
        c = ppl.compile(m, (torch.as_tensor(y),))
        assert c.plate_name == "outer" and c.n_shards == 4
        assert c.local_sites == ["z"] and c.global_sites == ["w"]
        p = c.sample_prior(_gen(0))
        assert p["z"].shape == (4, 2)
        direct = ppl.log_density(m, (torch.as_tensor(y),), p)
        np.testing.assert_allclose(float(c.logp(p)), float(direct), rtol=1e-6)
        v, g = c.logp_and_grad(p)
        _close(v, g, *_jax_value_and_grad(m_of(jppl, jdist.Normal), (y,),
                                          {k: t.numpy() for k, t in p.items()}))

    def test_condition_attached_data_compiles_correctly(self, tiny_data, tiny_np):
        """Data attached via ``condition`` (never passing through
        ``subsample``) carries the FULL plate axis into the per-shard
        lane — the plate must gather it, not let broadcasting count the
        whole dataset once per shard."""

        def latent_of(p, N):
            def latent_model(x):
                w = p.sample("w", N(0.0, 1.0))
                with p.plate("shards", 4):
                    b = p.sample("b", N(0.0, 1.0))
                    p.sample("obs", N(w + b[:, None], 1.0))
            return latent_model

        conditioned = ppl.condition(latent_of(ppl, Normal), data={"obs": tiny_data})
        c = ppl.compile(conditioned, (tiny_data,))
        p = {"w": torch.tensor(0.3), "b": torch.ones((4,))}
        direct = ppl.log_density(conditioned, (tiny_data,), p)
        np.testing.assert_allclose(float(c.logp(p)), float(direct), rtol=1e-6)
        jcond = jppl.condition(latent_of(jppl, jdist.Normal), data={"obs": jnp.asarray(tiny_np)})
        v, g = c.logp_and_grad(p)
        _close(v, g, *_jax_value_and_grad(jcond, (tiny_np,),
                                          {"w": np.float32(0.3), "b": np.ones(4, np.float32)}))

    def test_wrong_size_plate_value_is_loud(self, tiny_data):
        """A plate-scoped value matching neither the effective nor the
        full plate size refuses instead of broadcasting."""

        def bad_model(x):
            w = ppl.sample("w", Normal(0.0, 1.0))
            with ppl.plate("shards", 4):
                ppl.sample("obs", Normal(w, 1.0), obs=x[:2])  # neither 1 nor 4

        with pytest.raises(PPLError, match="leading dim 2"):
            ppl.compile(bad_model, (tiny_data,)).logp({"w": torch.zeros(())})

    def test_permuted_full_length_indices_stay_aligned(self, tiny_data, tiny_np):
        """Under a FULL-LENGTH permuted index set, latents must still be
        gathered (an already-the-right-size pass-through would pair
        shard i's latent with shard j's data) — as in the JAX handlers;
        and the same under ``torch.func.vmap`` and inside a
        ``fed.program``'s recording, where the indices cannot be
        concretized."""
        params = {"w": torch.tensor(0.2), "b": torch.tensor([0.0, 1.0, 2.0, 3.0])}
        perm = [2, 0, 3, 1]
        tracer = ppl.trace(ppl.substitute(tiny_model, data=params))
        with ppl.force_subsample(indices={"shards": torch.as_tensor(perm)}, scale=False):
            tr = tracer.get_trace(tiny_data)
        np.testing.assert_array_equal(tr["b"]["value"].numpy(), [2.0, 0.0, 3.0, 1.0])
        np.testing.assert_array_equal(tr["obs"]["value"].numpy(), tiny_np[perm])
        jparams = {"w": jnp.asarray(0.2), "b": jnp.asarray([0.0, 1.0, 2.0, 3.0])}
        jtracer = jppl.trace(jppl.substitute(jtiny_model, data=jparams))
        with jppl.force_subsample(indices={"shards": jnp.asarray(perm)}, scale=False):
            jtr = jtracer.get_trace(jnp.asarray(tiny_np))
        _same_structure(_trace_summary(tr), _trace_summary(jtr))

        def lp(idx):
            with ppl.force_subsample(indices={"shards": idx}, scale=False):
                return ppl.log_density(tiny_model, (tiny_data,), params)

        want = float(lp(torch.as_tensor(perm)))
        batched = torch.func.vmap(lp)(torch.as_tensor([perm, [3, 2, 1, 0]]))
        np.testing.assert_allclose(batched.numpy(), [want, float(lp(torch.as_tensor([3, 2, 1, 0])))],
                                   rtol=1e-6)
        mesh = make_mesh({"shards": 2}, devices=[CPU] * 2)
        recorded = fed.program(lambda idx: lp(idx) + fed.fed_sum(fed.fed_map(
            lambda s: s * 0.0, torch.zeros(2))), fed.MeshPlacement(mesh))
        np.testing.assert_allclose(float(recorded(torch.as_tensor(perm))), want, rtol=1e-6)

    def test_permuted_indices_with_condition_data_is_loud(self, tiny_data, tiny_np):
        """An observed value that BYPASSED subsample() is shape-ambiguous
        under a full-length permuted index set (index-ordered vs
        full-order) — refuse loudly with the JAX package's text instead
        of silently misaligning rows.  Where the indices cannot be
        concretized (``torch.func.vmap``, a ``fed.program``'s recording)
        the value passes through, as under a JAX tracer, and no error of
        any other kind is swallowed."""

        def latent_of(p, N):
            def latent_model(x):
                w = p.sample("w", N(0.0, 1.0))
                with p.plate("shards", 4):
                    b = p.sample("b", N(0.0, 1.0))
                    p.sample("obs", N(w + b[:, None], 1.0))
            return latent_model

        conditioned = ppl.condition(latent_of(ppl, Normal), data={"obs": tiny_data})
        params = {"w": torch.tensor(0.1), "b": torch.zeros((4,))}
        tracer = ppl.trace(ppl.substitute(conditioned, data=params))

        def run(idx):
            with ppl.force_subsample(indices={"shards": idx}, scale=False):
                return tracer.get_trace(tiny_data)

        with pytest.raises(PPLError, match="ambiguous"):
            run(torch.as_tensor([3, 2, 1, 0]))
        jcond = jppl.condition(latent_of(jppl, jdist.Normal), data={"obs": jnp.asarray(tiny_np)})
        jtracer = jppl.trace(jppl.substitute(jcond, data={"w": jnp.asarray(0.1),
                                                          "b": jnp.zeros((4,))}))

        def jrun():
            with jppl.force_subsample(indices={"shards": jnp.asarray([3, 2, 1, 0])}, scale=False):
                jtracer.get_trace(jnp.asarray(tiny_np))

        assert _error(lambda: run(torch.as_tensor([3, 2, 1, 0]))) == _error(jrun)
        # the identity order is not ambiguous
        run(torch.arange(4))

        def lp(idx):
            with ppl.force_subsample(indices={"shards": idx}, scale=False):
                return ppl.log_density(conditioned, (tiny_data,), params)

        torch.func.vmap(lp)(torch.as_tensor([[3, 2, 1, 0], [0, 1, 2, 3]]))
        mesh = make_mesh({"shards": 2}, devices=[CPU] * 2)
        prog = fed.program(lambda idx: lp(idx) + fed.fed_sum(fed.fed_map(
            lambda s: s * 0.0, torch.zeros(2))), fed.MeshPlacement(mesh))
        assert math.isfinite(float(prog(torch.as_tensor([3, 2, 1, 0]))))

    def test_sample_prior_matches_template(self, tiny_data, tiny_np):
        c = ppl.compile(tiny_model, (tiny_data,))
        p = c.sample_prior(_gen(2))
        q = c.init_params()
        assert set(p) == set(q) == {"w", "b"}
        assert p["b"].shape == q["b"].shape == (4,)
        assert torch.equal(p["b"], c.sample_prior(_gen(2))["b"])
        # the JAX package's prior draw (its sample_prior's handler run),
        # carried across by params_from_jax, evaluates to JAX's value
        full = {"shards": jnp.arange(4)}
        tracer = jppl.trace(jppl.seed(jtiny_model, rng_key=jax.random.PRNGKey(2)))
        with jppl.force_subsample(indices=full, scale=False):
            jtr = tracer.get_trace(jnp.asarray(tiny_np))
        jp = {k: np.asarray(jtr[k]["value"]) for k in ("w", "b")}
        tp = params_from_jax(jp, device="cpu")
        assert {k: t.shape for k, t in tp.items()} == {k: t.shape for k, t in q.items()}
        v, g = c.logp_and_grad(tp)
        _close(v, g, *_jax_value_and_grad(jtiny_model, (tiny_np,), jp))
        v0, g0 = c.logp_and_grad(params_from_jax({k: np.zeros_like(v) for k, v in jp.items()},
                                                 device="cpu"))
        _close(v0, g0, *_jax_value_and_grad(jtiny_model, (tiny_np,),
                                            {k: np.zeros_like(v) for k, v in jp.items()}))

    def test_radon_matches_handwritten_glm(self):
        """The effectful radon model equals the port's hand-written
        ``HierarchicalRadonGLM`` up to the (gradient-free) HalfNormal
        normalizing constants it drops — values shift by a known
        constant, gradients match."""
        from pytensor_federated_torch.models.glm import HierarchicalRadonGLM, generate_radon_data

        model, args, _ = ppl.make_radon_example(8, mean_obs=6, seed=3, device="cpu")
        c = ppl.compile(model, args)
        p = c.sample_prior(_gen(5))
        data, _ = generate_radon_data(8, mean_obs=6, seed=3, device="cpu")
        glm = HierarchicalRadonGLM(data)
        v, g = c.logp_and_grad(p)
        vg, gg = glm.logp_and_grad(dict(p))
        const = 2 * 0.5 * math.log(2.0 / math.pi)
        np.testing.assert_allclose(float(v), float(vg) + const, rtol=1e-5)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), gg[k].numpy(), rtol=1e-4, atol=1e-5)


def _radon_np(n, seed=3, mean_obs=8):
    from pytensor_federated_tpu.ppl.radon import make_radon_example as jmake

    _, jargs, _ = jmake(n, mean_obs=mean_obs, seed=seed)
    return tuple(np.asarray(a) for a in jargs)


def _radon_points(c, n_points=3, seed=11):
    """``n_points`` seeded parameter points of the compiled model's
    shape: prior-scale normal draws from numpy."""
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(scale=0.5, size=tuple(t.shape)).astype(np.float32)
             for k, t in c.init_params().items()} for _ in range(n_points)]


@pytest.mark.parametrize("counties", [8, 16])
def test_radon_log_density_matches_jax(counties):
    """The radon model's bytes equal the JAX package's; its
    ``log_density``, compiled ``logp_and_grad`` and ``logp_indices``
    equal JAX ``log_density`` and ``jax.value_and_grad`` of it at three
    seeded points (index batches: under JAX ``force_subsample``)."""
    model, args, true = ppl.make_radon_example(counties, mean_obs=8, seed=3, device="cpu")
    jargs = _radon_np(counties)
    for t, j in zip(args, jargs):
        assert t.numpy().tobytes() == j.tobytes()
    c = ppl.compile(model, args)
    from pytensor_federated_tpu.ppl.radon import radon_model as jradon

    idx = np.random.default_rng(counties).choice(counties, size=counties // 2, replace=False)
    for pnp in _radon_points(c):
        p = params_from_jax(pnp, device="cpu")
        want = _jax_value_and_grad(jradon, jargs, pnp)
        _close(*value_and_grad_direct(model, args, p), *want)
        _close(*c.logp_and_grad(p), *want)
        vi, gi = value_and_grad_indices(c, p, idx)
        _close(vi, gi, *_jax_value_and_grad(jradon, jargs, pnp, force={"county": idx}))


def value_and_grad_direct(model, args, p):
    from pytensor_federated_torch.utils import value_and_grad

    return value_and_grad(lambda q: ppl.log_density(model, args, q), p)


def value_and_grad_indices(c, p, idx):
    from pytensor_federated_torch.utils import value_and_grad

    return value_and_grad(lambda q: c.logp_indices(q, idx), p)


def test_vmap_logp_equals_per_point_calls():
    """``torch.func.vmap(compiled.logp)`` — the samplers' chain batch —
    equals the per-point calls, and so does the vmapped value+grad."""
    model, args, _ = ppl.make_radon_example(8, mean_obs=8, seed=3, device="cpu")
    c = ppl.compile(model, args)
    points = [params_from_jax(p, device="cpu") for p in _radon_points(c, 4)]
    stacked = {k: torch.stack([p[k] for p in points]) for k in points[0]}
    batched = torch.func.vmap(c.logp)(stacked)
    single = torch.stack([c.logp(p) for p in points])
    np.testing.assert_allclose(batched.numpy(), single.numpy(), rtol=1e-6)
    from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad
    from pytensor_federated_torch.samplers.util import ravel, ravel_batch

    _, unravel = ravel(points[0])
    lg = make_batch_logp_and_grad(lambda x: c.logp(unravel(x)), unravel)
    vals, grads = lg(ravel_batch(stacked))
    for i, p in enumerate(points):
        v, g = c.logp_and_grad(p)
        np.testing.assert_allclose(float(vals[i]), float(v), rtol=1e-6)
        np.testing.assert_allclose(grads[i].numpy(), ravel(g)[0].numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# hypothesis: unbiasedness as a property
# ---------------------------------------------------------------------------


def test_subsample_unbiasedness_property(tiny_data):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    c = ppl.compile(tiny_model, (tiny_data,))

    @settings(max_examples=15, deadline=None)
    @given(w=st.floats(-3.0, 3.0), bseed=st.integers(0, 2**16), m=st.integers(1, 4))
    def check(w, bseed, m):
        params = {"w": torch.tensor(w, dtype=torch.float32),
                  "b": torch.as_tensor(np.random.default_rng(bseed).normal(size=4),
                                       dtype=torch.float32)}
        full = float(c.logp(params))
        vals = [float(c.logp_indices(params, torch.as_tensor(idx)))
                for idx in itertools.combinations(range(4), m)]
        np.testing.assert_allclose(np.mean(vals), full, rtol=1e-4, atol=1e-3)

    check()


# ---------------------------------------------------------------------------
# placements: the same program on every lane
# ---------------------------------------------------------------------------


def _serve_thread(compute, serve=serve_tcp_once):
    box, ready = {}, threading.Event()
    threading.Thread(
        target=serve, args=(compute,), daemon=True,
        kwargs=dict(ready_callback=lambda p: (box.update(p=p), ready.set()), concurrent=True),
    ).start()
    assert ready.wait(TIMEOUT_S)
    return box["p"]


class TestPlacements:
    """The JAX package's ``TestPlacements`` (red under the driver's JAX),
    held against JAX ``log_density`` and ``jax.value_and_grad`` here."""

    @pytest.fixture(scope="class")
    def radon(self):
        model, args, _ = ppl.make_radon_example(16, mean_obs=6, seed=3, device="cpu")
        dense = ppl.compile(model, args)
        params = dense.sample_prior(_gen(2))
        from pytensor_federated_tpu.ppl.radon import radon_model as jradon

        want_v, want_g = _jax_value_and_grad(jradon, _radon_np(16, mean_obs=6),
                                             {k: t.numpy() for k, t in params.items()})
        return model, args, dense, params, want_v, want_g

    @pytest.fixture(scope="class")
    def node(self, radon):
        return _serve_thread(radon[2].node_compute())

    @pytest.fixture(scope="class")
    def mesh8(self):
        return make_mesh({"shards": 8}, devices=[CPU] * 8)

    def _check(self, compiled, params, want_v, want_g):
        _close(*compiled.logp_and_grad(params), want_v, want_g)

    def test_mesh_placement(self, radon, mesh8):
        model, args, dense, params, v, g = radon
        c = ppl.compile(model, args, placement=fed.MeshPlacement(mesh8))
        self._check(c, params, v, g)
        self._check(dense, params, v, g)

    def test_mesh_indivisible_is_loud(self, mesh8):
        def m(y):
            with ppl.plate("n", 6) as p:
                ppl.sample("obs", Normal(ppl.sample("w", Normal()), 1.0), obs=ppl.subsample(y, p))

        with pytest.raises(PPLError, match="not divisible"):
            ppl.compile(m, (torch.zeros((6, 2)),), placement=fed.MeshPlacement(mesh8))

    def test_pool_placement(self, radon, node):
        model, args, _dense, params, v, g = radon
        cli = TcpArraysClient("127.0.0.1", node)
        try:
            c = ppl.compile(model, args, placement=fed.PoolPlacement(cli, window=8))
            self._check(c, params, v, g)
        finally:
            cli.close()

    def test_pool_reduced_windows(self, radon, node):
        """PoolPlacement(reduce=True): the compiler's canonical round
        keeps every inexact mapped operand broadcast-derived, so the
        reduced-window lowering stays eligible (one ``fed.reduce_window``
        flight event, no per-shard window)."""
        from pytensor_federated_torch.telemetry import flightrec, spans

        model, args, _dense, params, v, g = radon
        pool = NodePool([("127.0.0.1", node)], transport="tcp")
        was = spans.set_enabled(True), flightrec.set_enabled(True)
        try:
            c = ppl.compile(model, args, placement=fed.PoolPlacement(
                PooledArraysClient(pool), window=8, reduce=True, tag="svi"))
            flightrec.clear()
            self._check(c, params, v, g)
            kinds = [e for e in flightrec.events() if e["kind"].startswith("fed.")]
            assert [e["kind"] for e in kinds] == ["fed.reduce_window"] and kinds[0]["lane"] == "svi"
        finally:
            spans.set_enabled(was[0])
            flightrec.set_enabled(was[1])
            pool.close()

    def test_mixed_placement(self, radon, node, mesh8):
        model, args, _dense, params, v, g = radon
        cli = TcpArraysClient("127.0.0.1", node)
        try:
            c = ppl.compile(model, args, placement=fed.MixedPlacement(
                fed.MeshPlacement(mesh8), fed.PoolPlacement(cli, window=8), pool_shards=8))
            self._check(c, params, v, g)
            # the subsample lane over the mixed placement, against JAX
            idx = np.random.default_rng(6).permutation(16)
            from pytensor_federated_tpu.ppl.radon import radon_model as jradon

            _close(*value_and_grad_indices(c, params, idx),
                   *_jax_value_and_grad(jradon, _radon_np(16, mean_obs=6),
                                        {k: t.numpy() for k, t in params.items()},
                                        force={"county": idx}))
        finally:
            cli.close()

    def test_seeded_prior_identical_across_placements(self, radon, node, mesh8):
        """sample_prior is placement-independent: same generator state,
        same draws, whatever lane the logp runs on."""
        model, args, dense, *_ = radon
        cli = TcpArraysClient("127.0.0.1", node)
        try:
            lanes = [
                dense,
                ppl.compile(model, args, placement=fed.MeshPlacement(mesh8)),
                ppl.compile(model, args, placement=fed.PoolPlacement(cli, window=8)),
            ]
            draws = [lane.sample_prior(_gen(11)) for lane in lanes]
            for other in draws[1:]:
                for k in draws[0]:
                    assert torch.equal(draws[0][k], other[k])
        finally:
            cli.close()


# ---------------------------------------------------------------------------
# against the JAX CompiledModel itself (where the installed JAX traces it)
# ---------------------------------------------------------------------------


@NEEDS_JAX_FED
class TestAgainstTheJaxCompiledModel:
    @pytest.fixture(scope="class")
    def pair(self):
        from pytensor_federated_tpu.ppl.radon import make_radon_example as jmake

        jmodel, jargs, _ = jmake(16, mean_obs=6, seed=3)
        jc = jppl.compile(jmodel, jargs)
        model, args, _ = ppl.make_radon_example(16, mean_obs=6, seed=3, device="cpu")
        return jmodel, jargs, jc, model, args

    def test_prior_draw_and_init_carried_across(self, pair):
        _jm, _ja, jc, model, args = pair
        c = ppl.compile(model, args)
        for jp in (jc.sample_prior(jax.random.PRNGKey(4)), jc.init_params()):
            jp_np = {k: np.asarray(v) for k, v in jp.items()}
            jv, jg = jc.logp_and_grad(jp)
            _close(*c.logp_and_grad(params_from_jax(jp_np, device="cpu")), float(jv),
                   {k: np.asarray(t) for k, t in jg.items()})

    def test_mesh_and_pool_lanes(self, pair):
        """The port's mesh, pool and mixed lanes against the JAX
        ``CompiledModel``'s dense lane (its own mesh and pool lanes are
        red under the driver's JAX: the JAX tree's ``TestPlacements``)."""
        _jm, _ja, jc, model, args = pair
        jp = jc.sample_prior(jax.random.PRNGKey(7))
        jv, jg = jc.logp_and_grad(jp)
        want = (float(jv), {k: np.asarray(t) for k, t in jg.items()})
        p = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
        dense = ppl.compile(model, args)
        port = _serve_thread(dense.node_compute())
        cli = TcpArraysClient("127.0.0.1", port)
        try:
            mesh = fed.MeshPlacement(make_mesh({"shards": 8}, devices=[CPU] * 8))
            pool = fed.PoolPlacement(cli, window=8)
            for placement in (None, mesh, pool, fed.MixedPlacement(mesh, pool, pool_shards=8)):
                _close(*ppl.compile(model, args, placement=placement).logp_and_grad(p), *want)
        finally:
            cli.close()

    def test_svi_fit_against_the_jax_svi_fit(self, pair):
        """``svi_fit`` with the draws the JAX ``svi_fit`` makes from its
        key injected follows the JAX ``svi_fit`` at float32 rounding."""
        jmodel, jargs, jc, model, args = pair
        steps, n_mc, lr = 20, 4, 2e-2
        key = jax.random.PRNGKey(2)
        jres, _ = jppl.svi_fit(jc, key=key, num_steps=steps, n_mc=n_mc, learning_rate=lr)
        dim = int(jres.flat_mean.shape[0])
        eps = [torch.as_tensor(np.array(jax.random.normal(k, (n_mc, dim), jnp.float32)))
               for k in jax.random.split(key, steps)]
        res, _ = ppl.svi_fit(ppl.compile(model, args), generator=_gen(0), num_steps=steps,
                             n_mc=n_mc, learning_rate=lr, noise=eps)
        np.testing.assert_allclose(res.elbo_trace.numpy(), np.asarray(jres.elbo_trace), rtol=1e-5)
        np.testing.assert_allclose(res.flat_mean.numpy(), np.asarray(jres.flat_mean), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res.flat_log_sd.numpy(), np.asarray(jres.flat_log_sd),
                                   rtol=1e-4, atol=1e-5)
