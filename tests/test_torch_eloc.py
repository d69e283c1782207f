"""Port parity: local energies.

SIMPLE against the JAX package in f64 (1e-10); REDUCE with k_det = n_sd
(no tail) equal to SIMPLE (1e-10); REDUCE with a stochastic tail
unbiased against SIMPLE over many independent draws."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.energy.eloc import local_energy_simple as jsimple
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.energy.eloc import (
    local_energy_reduce,
    local_energy_simple,
    sample_tail_cdf,
)
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import integrals
from pynqs_tpu_torch.utils.system import System

SORB, NOA, NOB = 10, 2, 2


def _setup(kind):
    if kind == "hubbard":
        js = JSystem.hubbard_1d(SORB // 2, NOA, NOB, u=4.0)
        ts = System.hubbard_1d(SORB // 2, NOA, NOB, u=4.0)
    else:
        rng = np.random.default_rng(5)
        h1e = rng.standard_normal((SORB, SORB)) * 0.3
        h1e = (h1e + h1e.T) / 2
        h2e = rng.standard_normal(integrals.triangle_size(SORB)) * 0.1
        js = JSystem.from_integrals(h1e, h2e, SORB, NOA, NOB)
        ts = System.from_integrals(h1e, h2e, SORB, NOA, NOB)
    jm = JModel(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn")
    params = jm.init(jax.random.PRNGKey(0))
    tm = GraphMPSRNN(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                     device="cpu")
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return js, ts, jm, params, tm


def _fwd(tm):
    return lambda b: tm.log_psi(b).detach()


@pytest.mark.parametrize("kind", ["hubbard", "random"])
@pytest.mark.parametrize("batch", [None, 7])
def test_local_energy_simple_matches_jax(kind, batch):
    js, ts, jm, params, tm = _setup(kind)
    bits = fci.fci_bits(SORB, NOA, NOB)
    ref = jsimple(partial(jm.log_psi, params), jnp.asarray(bits), js.tables.astuple(),
                  js.excitation, hpair=js.tables.hpair_sect)
    tt = ts.tables("cpu")
    out = local_energy_simple(_fwd(tm), torch.as_tensor(bits), tt.astuple(), ts.excitation,
                              batch=batch, hpair=tt.hpair_sect)
    assert out.shape == (bits.shape[0], 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10, rtol=0)


@pytest.mark.parametrize("topk", ["exact", "segmax"])
def test_reduce_without_tail_equals_simple(topk):
    """k_det = n_sd sums every term exactly (segmax: every element wins
    its own segment); the tail is empty and contributes 0."""
    _, ts, _, _, tm = _setup("random")
    bits = torch.as_tensor(fci.fci_bits(SORB, NOA, NOB))
    tt = ts.tables("cpu")
    e_simple = local_energy_simple(_fwd(tm), bits, tt.astuple(), ts.excitation,
                                   hpair=tt.hpair_sect)
    e_red = local_energy_reduce(_fwd(tm), bits, tt.astuple(), ts.excitation,
                                torch.Generator().manual_seed(1), k_det=ts.excitation.n_sd,
                                n_stoch=4, batch=11, hpair=tt.hpair_sect, topk=topk)
    np.testing.assert_allclose(e_red.numpy(), e_simple.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("topk", ["exact", "segmax"])
def test_reduce_is_unbiased(topk):
    """6 rows, each repeated 400 times: every copy draws its own tail, so
    the copies are independent estimates.  Their mean must lie within 5
    standard errors of SIMPLE."""
    _, ts, _, _, tm = _setup("random")
    rows = torch.as_tensor(fci.fci_bits(SORB, NOA, NOB)[::17][:6])
    tt = ts.tables("cpu")
    ref = local_energy_simple(_fwd(tm), rows, tt.astuple(), ts.excitation,
                              hpair=tt.hpair_sect).numpy()
    reps = 400
    es = local_energy_reduce(_fwd(tm), rows.repeat(reps, 1), tt.astuple(), ts.excitation,
                             torch.Generator().manual_seed(2), k_det=8, n_stoch=16,
                             hpair=tt.hpair_sect, topk=topk)
    es = es.numpy().reshape(reps, rows.shape[0], 2)
    mean, se = es.mean(0), es.std(0) / np.sqrt(reps)
    assert (se[:, 0] > 0).all(), "the tail must be stochastic at k_det < n_sd"
    assert (np.abs(mean - ref) < 5 * se + 1e-9).all(), (mean - ref, se)


def test_sample_tail_cdf_draws_follow_the_residual():
    """Draw frequencies ∝ resid (within 5σ of the stratified bound) and
    no draw lands on a screened-out (zero) entry."""
    rng = np.random.default_rng(3)
    resid = np.abs(rng.standard_normal((1, 40)))
    resid[0, ::5] = 0.0
    n = 20000
    draw = sample_tail_cdf(torch.as_tensor(resid), n, torch.Generator().manual_seed(4))
    assert draw.shape == (1, n)
    freq = np.bincount(draw[0].numpy(), minlength=40) / n
    p = resid[0] / resid.sum()
    assert (freq[p == 0] == 0).all()
    # stratified draws have at most the variance of iid ones
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12).all()
