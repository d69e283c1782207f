"""``evaluate`` (f32 forward) against an exact sum over the whole FCI space
built from the JAX package's dense Hamiltonian and the JAX model's ψ."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ops import integrals as jints
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.ops.hamiltonian import hij_dense
from pynqs_tpu.utils import fci as jfci

from pynqs_tpu_torch.scripts.eval_fe2s2_final import evaluate
from pynqs_tpu_torch.utils.system import System

from test_torch_eval import NOA, NOB, SORB, _integrals, _models


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
