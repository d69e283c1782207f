"""Port parity: the final-state evaluation and what it is built from.

The operator tables (``spin_raising``, ``System.with_operator``), the
weighted statistics, the spin-flip helpers and ``add_exp`` against the
JAX package; ``ExactSampler`` and ``VMC.operator_expected`` against the
JAX package's on the same parameters (f64, 1e-10); ``evaluate`` (f32
forward) against an exact sum over the whole FCI space built from the
JAX package's dense Hamiltonian and the JAX model's ψ; the REDUCE
``topk="approx"`` against the JAX package's."""

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.energy.eloc import local_energy_reduce as jreduce
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops import cplx as jcplx
from pynqs_tpu.ops import integrals as jints
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.ops.hamiltonian import hij_dense
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JVMCConfig
from pynqs_tpu.sampler.exact import ExactSampler as JExact
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci as jfci
from pynqs_tpu.utils import stats as jstats

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import cplx, integrals, onv
from pynqs_tpu_torch.ops.hamiltonian import comb_hij
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.scripts.eval_fe2s2_final import evaluate
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


def _reference(jm, params, h1e, h2e, rows, eta):
    """Σ_{n∈rows} w_n Σ_m O_nm ψ(m)/ψ(n) over the whole FCI space for H
    and S⁻S⁺, w_n ∝ |ψ(n)|² over ``rows``; with eta ≠ 0 ψ is the
    projected ψ_P(n) = ½ψ(n) + ½η·sign_SF(n)·ψ(flip(n))."""
    space = jfci.fci_bits(SORB, NOA, NOB)
    lp = np.asarray(jm.log_psi(params, jnp.asarray(space)))
    psi = np.exp(lp[:, 0] + 1j * lp[:, 1])
    if eta:
        key = {r.tobytes(): i for i, r in enumerate(space)}
        flip = np.asarray(jonv.spin_flip_bits(jnp.asarray(space)))
        sgn = np.asarray(jonv.spin_flip_sign(jnp.asarray(space)))
        psi = 0.5 * psi + 0.5 * eta * sgn * psi[[key[r.tobytes()] for r in flip]]
    index = {r.tobytes(): i for i, r in enumerate(space)}
    live = np.array([index[r.tobytes()] for r in rows])
    # with eta = -1 at an even number of doubly occupied orbitals, ψ_P
    # of a closed-shell determinant is 0: weight 0, no term
    live = live[np.abs(psi[live]) > 1e-12 * np.abs(psi).max()]
    w = np.abs(psi[live]) ** 2
    w /= w.sum()
    out = []
    for hh1, hh2 in ((h1e, h2e), jints.spin_raising(SORB)):
        t = jints.precompute_hij_tables(hh1, hh2, SORB)
        O = np.asarray(hij_dense(jnp.asarray(space[live]), jnp.asarray(space), t.h1e, t.h2e,
                                 t.diag1, t.K, t.J))
        out.append(float(np.real((w * (O @ psi) / psi[live]).sum())))
    return out


@pytest.mark.parametrize("spin_project", [0, -1])
def test_evaluate_matches_the_exact_sum(spin_project):
    """k_det = 0 (exact), f32 forward (the plain fused forward on the
    CPU): the Rao-Blackwellized E and ⟨S⁻S⁺⟩ equal the reference over the
    port's live rows to 1e-5 relative (f32 forward against f64)."""
    h1e, h2e = _integrals()
    jm, params, tm = _models(torch.float32, seed=2)
    ts = System.from_integrals(h1e, h2e, SORB, NOA, NOB, ecore=1.25)
    reps = evaluate(tm, ts, n_sample=100_000, capacity=256, n_group=2, split_depth=2,
                    k_det=0, batch=64, n_rep=2, spin_project=spin_project, fwd_dtype="f32",
                    generator=torch.Generator().manual_seed(0), device="cpu")
    assert len(reps) == 2
    for r in reps:
        assert 0 < r.n_live <= 36 and 0.0 <= r.dropped < 1e-3
        e_ref, s_ref = _reference(jm, params, h1e, h2e, r.rows.numpy(), spin_project)
        assert abs(r.e - 1.25 - e_ref) <= 1e-5 * abs(e_ref), (r.e - 1.25, e_ref)
        assert abs(r.s - s_ref) <= 1e-5 * max(abs(s_ref), 1.0), (r.s, s_ref)
        assert math.isfinite(r.e_ct) and r.var >= 0.0 and r.s_se >= 0.0
        assert "E = " in r.line(0) and "mHa" in r.line(0, e_ref=r.e)


def test_evaluate_on_the_cpu_takes_the_exact_forward(monkeypatch):
    """As the JAX script off the accelerator: ``model.log_psi``, never the
    fused forward, so ``fwd_dtype`` changes nothing on the CPU."""
    from pynqs_tpu_torch.ops import fused_rnn

    def boom(*a, **k):
        raise AssertionError("the fused forward ran on the CPU")

    monkeypatch.setattr(fused_rnn, "graph_mpsrnn_logpsi_fused", boom)
    h1e, h2e = _integrals()
    _, _, tm = _models(torch.float32, seed=2)
    ts = System.from_integrals(h1e, h2e, SORB, NOA, NOB)
    reps = {mm: evaluate(tm, ts, n_sample=10_000, capacity=64, n_group=2, split_depth=2,
                         k_det=6, n_stoch=4, batch=16, n_rep=1, fwd_dtype=mm,
                         generator=torch.Generator().manual_seed(0), device="cpu")[0]
            for mm in ("bf16", "f32")}
    for f in ("e", "e_ct", "var", "s", "dropped", "n_live"):
        assert getattr(reps["bf16"], f) == getattr(reps["f32"], f), f
    assert torch.equal(reps["bf16"].rows, reps["f32"].rows)


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
