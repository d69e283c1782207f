"""Port parity: the one-shot CI-NQS polish (``ci/nqs_ci.ci_polish``) and its
script, on the system of ``tests/test_nqs_ci.py`` (sorb 8, 2α/2β, seeded
random integrals, ``GraphMPSRNN(dcut=6)``, f64).

``ci_polish`` against the JAX package's in both ``restrict`` modes, on
the whole space and on a partial capture, with k_det = n_sd (1e-8);
against the brute-force projection of H onto span{|d_i⟩, φ̂} (1e-8);
dead capture slots and D members finite in f32 (the JAX package's f32
regression); ``fe2s2_ci_polish.main`` at a tiny size."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ci.nqs_ci import ci_polish as jci_polish
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.ci.nqs_ci import ci_polish
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.hamiltonian import hij_dense
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.scripts import fe2s2_ci_polish
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.checkpoint import save_params
from pynqs_tpu_torch.utils.flagship import flagship_model
from pynqs_tpu_torch.utils.system import System

SORB, NOA, NOB = 8, 2, 2


def _setup(seed, key, dtype=np.float64, jax_model=True):
    """(port system, JAX system, JAX model, its params, port model, space,
    dense H, ψ over the space); without ``jax_model`` the port model draws
    its own weights from ``key``."""
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((SORB, SORB)) * 0.3
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(SORB)) * 0.1
    ts = System.from_integrals(h1e, h2e, SORB, NOA, NOB, dtype=dtype)
    js = JSystem.from_integrals(h1e, h2e, SORB, NOA, NOB, dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jm = params = None
    tm = GraphMPSRNN(SORB, NOA, NOB, dcut=6, dtype=tdt, device="cpu",
                     generator=torch.Generator().manual_seed(key))
    if jax_model:
        jm = JModel(SORB, NOA, NOB, dcut=6)
        params = jm.init(jax.random.PRNGKey(key))
        tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    space = fci.fci_bits(SORB, NOA, NOB)
    H = hij_dense(torch.as_tensor(space), torch.as_tensor(space),
                  *ts.tables("cpu").astuple()).double().numpy()
    lp = tm.log_psi(torch.as_tensor(space)).detach().double().numpy()
    psi = np.exp(lp[:, 0]) * np.exp(1j * lp[:, 1])
    return ts, js, jm, params, tm, space, H, psi


def _capture(space, d_idx, kind):
    if kind == "full":
        return space
    rest = np.setdiff1d(np.arange(len(space)), d_idx)
    return space[np.sort(np.concatenate([d_idx, rest[::2]]))]


@pytest.mark.parametrize("restrict,kind", [("complement", "full"), ("capture", "partial")])
def test_ci_polish_equals_jax(restrict, kind):
    ts, js, jm, params, tm, space, _, psi = _setup(9, 2)
    d_idx = np.sort(np.argsort(-np.abs(psi))[:6])
    cap = _capture(space, d_idx, kind)
    kw = dict(k_det=ts.excitation.n_sd, n_stoch=4, ci_chunk=6, restrict=restrict)
    e, c, info = ci_polish(tm, ts, space[d_idx], cap, torch.Generator().manual_seed(7),
                           device="cpu", **kw)
    je, jc, jinfo = jci_polish(jm, params, js, jnp.asarray(space[d_idx]), jnp.asarray(cap),
                               jax.random.PRNGKey(7), **kw)
    assert abs(e - je) < 1e-8, (e, je)
    assert abs(abs(c[-1]) - abs(jc[-1])) < 1e-6
    for k in ("h_nn", "norm2_complement", "captured_complement_fraction", "ci_mass", "c_m2"):
        assert abs(info[k] - jinfo[k]) < 1e-8, (k, info[k], jinfo[k])
    assert info["restrict"] == restrict


@pytest.mark.parametrize("restrict", ["complement", "capture"])
def test_ci_polish_equals_bruteforce_projection(restrict):
    """The eigenvalue of H projected onto the d_i columns and φ zeroed on D
    (complement, whole space captured) or outside (capture \\ D) (capture,
    half the rest captured): 1e-8, and FCI ≤ E ≤ E_VMC."""
    ts, _, _, _, tm, space, H, psi = _setup(11, 6, jax_model=False)
    d_idx = np.sort(np.argsort(-np.abs(psi))[:5])
    kind = "full" if restrict == "complement" else "partial"
    cap = _capture(space, d_idx, kind)
    e, c, info = ci_polish(tm, ts, space[d_idx], cap, torch.Generator().manual_seed(8),
                           k_det=ts.excitation.n_sd, n_stoch=4, ci_chunk=4,
                           restrict=restrict, device="cpu")
    n = len(space)
    B = np.zeros((n, 6), complex)
    B[d_idx, np.arange(5)] = 1.0
    cap_set = {tuple(r) for r in cap}
    keep = [i for i in range(n) if i not in d_idx and tuple(space[i]) in cap_set]
    B[keep, 5] = psi[keep]
    B[:, 5] /= np.linalg.norm(B[:, 5])
    e_ref = np.linalg.eigvalsh(B.conj().T @ H @ B)[0]
    e_vmc = float(np.real(np.vdot(psi, H @ psi)))
    assert abs(e - e_ref) < 1e-8, (e, e_ref)
    assert np.linalg.eigvalsh(H)[0] - 1e-9 <= e <= e_vmc + 1e-9
    assert abs(np.linalg.norm(c) - 1.0) < 1e-10
    cov = info["captured_complement_fraction"]
    assert cov > 0.999 if kind == "full" else abs(cov - 1.0) > 1e-3


def test_ci_polish_f32_dead_slots_and_members_finite():
    """f32: the masked forward's −690 floor is an exact zero on D rows, and
    the capture carries dead all-zero padding (count 0); both are dropped
    before the local energy, so the energy is finite, the padding does not
    move it, and FCI ≤ E ≤ E_VMC (5e-6)."""
    ts, _, _, _, tm, space, H, _ = _setup(3, 4, np.float32, jax_model=False)
    lp = tm.log_psi(torch.as_tensor(space)).detach()
    assert lp.dtype == torch.float32
    d_idx = np.sort(np.argsort(-lp[:, 0].numpy())[:6])
    capture = np.concatenate([space, np.zeros((8, SORB), np.int8)])
    counts = np.concatenate([np.ones(len(space)), np.zeros(8)])
    kw = dict(k_det=ts.excitation.n_sd, n_stoch=4, ci_chunk=4, device="cpu")
    e, _, info = ci_polish(tm, ts, space[d_idx], capture, torch.Generator().manual_seed(7),
                           sample_counts=counts, **kw)
    assert np.isfinite(e) and np.isfinite(info["h_nn"])
    e_ref, _, _ = ci_polish(tm, ts, space[d_idx], space, torch.Generator().manual_seed(7), **kw)
    assert abs(e - e_ref) < 5e-6, (e, e_ref)
    lp64 = lp.double().numpy()
    psi = np.exp(lp64[:, 0]) * np.exp(1j * lp64[:, 1])
    psi /= np.linalg.norm(psi)
    e_vmc = float(np.real(np.vdot(psi, H @ psi)))
    assert np.linalg.eigvalsh(H)[0] - 1e-5 <= e <= e_vmc + 1e-5
    with pytest.raises(ValueError, match="no usable captured rows"):
        ci_polish(tm, ts, space[d_idx], space[d_idx], torch.Generator(), **kw)


def test_ci_polish_script_main_on_the_cpu(tmp_path, capsys):
    """The script on a 16-orbital stand-in (the DAG with tensor coupling,
    dcut 4), exact eloc: both modes, an m sweep; every energy finite, the
    capture-mode polish at or below the same-set E_VMC."""
    rng = np.random.default_rng(5)
    sorb = 16
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    system = System.from_integrals(h1e, rng.standard_normal(triangle_size(sorb)) * 0.02,
                                   sorb, 2, 2, ecore=1.5)
    m = flagship_model(system, 4, use_tensor=True, max_preds=2, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    save_params(str(tmp_path / "s.pkl"), dict(m.named_parameters()))
    argv = [str(tmp_path / "s.pkl"), "--dcut", "4", "--use-tensor", "--max-preds", "2",
            "--n-sample", "20000", "--capacity", "64", "--n-group", "2", "--split-depth", "2",
            "--m", "4,16", "--k-det", "0", "--eloc-batch", "32", "--ci-chunk", "8"]
    out = fe2s2_ci_polish.main(argv, system=system, device="cpu")
    text = capsys.readouterr().out
    assert "E_VMC (exact weights, same set)" in text and "| 16 |" in text
    assert [r["m"] for r in out["results"]] == [4, 16] and out["n_live"] > 16
    for r in out["results"]:
        assert np.isfinite(r["e"]) and r["e"] <= out["e_vmc"] + 1e-5
        assert 0.0 <= r["info"]["captured_complement_fraction"] <= 1.0 + 1e-9
    comp = fe2s2_ci_polish.main(argv + ["--restrict", "complement", "--fwd-dtype", "f32",
                                        "--m", "8"], system=system, device="cpu")
    assert comp["results"][0]["info"]["restrict"] == "complement"
    assert abs(comp["e_vmc"] - out["e_vmc"]) < 1e-12  # the CPU forward is model.log_psi
    with pytest.raises(ValueError, match="no captured row"):
        fe2s2_ci_polish.main(argv[:-6] + ["--m", "100000"], system=system, device="cpu")
