"""``ExactSampler`` and ``VMC.operator_expected`` against the JAX package's
on the same parameters (f64, 1e-10), and the REDUCE ``topk="approx"``
against the JAX package's."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.energy.eloc import local_energy_reduce as jreduce
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JVMCConfig
from pynqs_tpu.sampler.exact import ExactSampler as JExact
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci as jfci

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.ops import integrals
from pynqs_tpu_torch.ops.hamiltonian import comb_hij
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.utils.system import System

from test_torch_eval import NOA, NOB, SORB, _integrals, _models


@pytest.mark.parametrize("method", ["simple", "reduce"])
def test_operator_expected_matches_jax(method):
    """⟨S⁻S⁺⟩ and ⟨H⟩ under the exact measure, SIMPLE and REDUCE with
    k_det = n_sd (every term, an empty tail): JAX's values to 1e-10."""
    h1e, h2e = _integrals()
    jm, params, tm = _models()
    js = JSystem.from_integrals(h1e, h2e, SORB, NOA, NOB)
    ts = System.from_integrals(h1e, h2e, SORB, NOA, NOB)
    n_sd = ts.excitation.n_sd
    jv = JVMC(jm, js, JExact(SORB, NOA, NOB),
              JVMCConfig(eloc_method=method, eloc_k_det=n_sd, eloc_n_stoch=4))
    tv = VMC(tm, ts, ExactSampler(SORB, NOA, NOB),
             VMCConfig(eloc_method=method, eloc_k_det=n_sd, eloc_n_stoch=4,
                       fused_forward=False))
    for op in (integrals.spin_raising(SORB), (h1e, h2e)):
        a = tv.operator_expected(op, torch.Generator().manual_seed(0))
        b = jv.operator_expected(params, op, jax.random.PRNGKey(0))
        assert abs(a.mean - b.mean) < 1e-10, (a, b)
        assert abs(a.var - b.var) < 1e-10 and abs(a.n_eff - b.n_eff) < 1e-8
    s = tv.operator_expected(integrals.spin_raising(SORB), torch.Generator().manual_seed(0))
    assert s.mean.real > -1e-10  # S⁻S⁺ is positive semidefinite


def test_exact_sampler_weights_are_the_normalized_amplitudes():
    jm, params, tm = _models()
    bits, w, diag = ExactSampler(SORB, NOA, NOB).sample(tm)
    jb, jw, _, _ = JExact(SORB, NOA, NOB).sample(jm, params, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-14, rtol=0)
    assert diag["n_unique"].item() == 36 and diag["dropped_frac"].item() == 0.0


def test_reduce_topk_approx_matches_jax():
    """f64.  ``"approx"`` is an exact top-k off the TPU, in both packages:
    on the Hubbard chain the k_det screened terms cover every non-zero
    |H_nm| (an empty tail, whatever the draws), so the two agree to
    1e-12.  The port's "approx" also equals its "exact" bit for bit with
    a stochastic tail."""
    js = JSystem.hubbard_1d(SORB // 2, NOA, NOB, u=4.0)
    ts = System.hubbard_1d(SORB // 2, NOA, NOB, u=4.0)
    k_det = 10
    jm, params, tm = _models()
    bits = jfci.fci_bits(SORB, NOA, NOB)[::3]
    tt = ts.tables("cpu")
    fwd = lambda b: tm.log_psi(b).detach()  # noqa: E731

    def run(topk, kd=k_det, seed=0):
        return local_energy_reduce(fwd, torch.as_tensor(bits), tt.astuple(), ts.excitation,
                                   torch.Generator().manual_seed(seed), k_det=kd, n_stoch=6,
                                   hpair=tt.hpair, topk=topk)

    _, hij = comb_hij(torch.as_tensor(bits), *tt.astuple(), tt.hpair, table=ts.excitation)
    assert ((hij[:, 1:] != 0).sum(1) <= k_det).all()  # the tail is empty
    ref = jreduce(partial(jm.log_psi, params), jnp.asarray(bits), js.tables.astuple(),
                  js.excitation, jax.random.PRNGKey(0), k_det=k_det, n_stoch=6,
                  hpair=js.tables.hpair, topk="approx")
    np.testing.assert_allclose(run("approx").numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    assert torch.equal(run("approx", 7, 5), run("exact", 7, 5))
