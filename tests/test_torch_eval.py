"""Port parity: what the final-state evaluation is built from.

The operator tables (``spin_raising``, ``System.with_operator``), the
weighted statistics, the spin-flip helpers and ``add_exp`` against the
JAX package.  ``ExactSampler``, ``VMC.operator_expected`` and the REDUCE
``topk="approx"`` are in ``tests/test_torch_eval_operator.py``,
``evaluate`` in ``tests/test_torch_eval_evaluate.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops import cplx as jcplx
from pynqs_tpu.ops import integrals as jints
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.sampler.exact import ExactSampler as JExact
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci as jfci
from pynqs_tpu.utils import stats as jstats

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import cplx, integrals, onv
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.utils import fci, stats
from pynqs_tpu_torch.utils.system import System

SORB, NOA, NOB = 8, 2, 2


def _integrals(seed=4):
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((SORB, SORB)) * 0.3
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(integrals.triangle_size(SORB)) * 0.1
    return h1e, h2e


def _models(dtype=torch.float64, seed=1):
    jm = JModel(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn")
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GraphMPSRNN(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                     dtype=dtype, device="cpu")
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


@pytest.mark.parametrize("sorb", [8, 12])
def test_spin_raising_and_with_operator_equal_jax(sorb):
    for a, b in zip(integrals.spin_raising(sorb, 0.7), jints.spin_raising(sorb, 0.7)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(sorb)
    h1e = rng.standard_normal((sorb, sorb))
    h2e = rng.standard_normal(integrals.triangle_size(sorb))
    op = integrals.spin_raising(sorb)
    ts = System.from_integrals(h1e, h2e, sorb, 2, 2).with_operator(*op, coeff=0.3)
    js = JSystem.from_integrals(h1e, h2e, sorb, 2, 2).with_operator(*op, coeff=0.3)
    np.testing.assert_array_equal(ts.h1e, js.h1e)
    np.testing.assert_array_equal(ts.h2e, js.h2e)
    for k in ("h1e", "h2e", "K", "J", "hpair"):
        np.testing.assert_array_equal(getattr(ts.tables("cpu"), k).numpy(),
                                      np.asarray(getattr(js.tables, k)))


def test_with_operator_builds_its_own_device_tables():
    h1e, h2e = _integrals()
    base = System.from_integrals(h1e, h2e, SORB, NOA, NOB)
    t0 = base.tables("cpu")
    t1 = base.with_operator(*integrals.spin_raising(SORB)).tables("cpu")
    assert not torch.equal(t0.h1e, t1.h1e)
    assert t0.hpair_best is t0.hpair_sect and t0.hpair.shape == (28, 28)


def test_weighted_stats_spin_flip_and_add_exp_match_jax():
    """f64, 1e-12."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(50)
    w = rng.random(50)
    w[::7] = 0.0
    v[::7] = np.nan  # dead rows are ignored
    w /= w.sum()
    for ns in (None, 1000):
        a = stats.weighted_stats(torch.as_tensor(v), torch.as_tensor(w), ns)
        b = jstats.weighted_stats(jnp.asarray(v), jnp.asarray(w), ns)
        np.testing.assert_allclose([x.item() for x in a], [float(x) for x in b],
                                   atol=1e-12, rtol=0)
    o = stats.operator_stats(torch.as_tensor(v), torch.as_tensor(w))
    jo = jstats.operator_stats(jnp.asarray(v), jnp.asarray(w))
    assert abs(o.mean - jo.mean) < 1e-12 and abs(o.se - jo.se) < 1e-12
    bits = jfci.fci_bits(SORB, NOA, NOB)
    np.testing.assert_array_equal(onv.spin_flip_bits(torch.as_tensor(bits)).numpy(),
                                  np.asarray(jonv.spin_flip_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(onv.spin_flip_sign(torch.as_tensor(bits)).numpy(),
                                  np.asarray(jonv.spin_flip_sign(jnp.asarray(bits))))
    lp1 = rng.standard_normal((30, 2)) * 3
    lp2 = rng.standard_normal((30, 2)) * 3
    lp2[:4] = lp1[:4]  # c1 + c2 = 0 cancels these rows
    for c1, c2 in ((0.5, 0.5), (0.5, -0.5), (1.0, 2.0)):
        a = cplx.add_exp(torch.as_tensor(lp1), torch.as_tensor(lp2), c1, c2).numpy()
        b = np.asarray(jcplx.add_exp(jnp.asarray(lp1), jnp.asarray(lp2), c1, c2))
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


def test_fci_bits_equal_jax():
    np.testing.assert_array_equal(fci.fci_bits(12, 3, 2), jfci.fci_bits(12, 3, 2))
    assert ExactSampler(12, 3, 2).n_states == JExact(12, 3, 2).n_states == 300
