"""Port parity: ``ci/solve.py`` (``cisd_space``, ``davidson``, ``solve_ci``,
``save_ci``/``load_ci``) and ``ci/train.py`` (``CITrain``) against the JAX
package, in f64 on the CPU.

``cisd_space`` equal row for row; ``solve_ci``'s energy and coefficients
to 1e-10 on the dense path and on forced Davidson paths; ``davidson``
equal to the JAX package's iteration bit for bit on one matvec and to ``eigh`` (1e-10
in the eigenvalue); the ``.npz`` files cross both ways, and the
repository's HCI spaces load; ``CITrain``'s three losses and parameters
over three Adam updates against optax.adam (1e-10)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ci import solve as jsolve
from pynqs_tpu.ci.train import CITrain as JCITrain
from pynqs_tpu.ci.train import CITrainConfig as JCITrainConfig
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops import hamiltonian as jham
from pynqs_tpu.sampler import ar as jar
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.ci import solve
from pynqs_tpu_torch.ci import train as ci_train
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.system import System

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _systems(seed, sorb, noa, nob):
    """(port system, JAX system) on the same seeded random integrals, f64."""
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((sorb, sorb)) * 0.3
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(sorb)) * 0.1
    return (System.from_integrals(h1e, h2e, sorb, noa, nob, ecore=0.7),
            JSystem.from_integrals(h1e, h2e, sorb, noa, nob, ecore=0.7))


@pytest.mark.parametrize("shape", [(8, 2, 2), (12, 3, 2), (16, 4, 4), (20, 1, 3)])
def test_cisd_space_equals_jax_row_for_row(shape):
    got = solve.cisd_space(*shape)
    want = jsolve.cisd_space(*shape)
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# solve_ci's keyword arguments per path: (port, JAX); "cached" holds the
# port's Davidson on the cached dense H (DENSE_MAX patched to 0) against
# the JAX package's Davidson with the blocks recomputed per matvec
PATHS = {"dense": ({}, {}),
         "chunked": ({"cache_max": 0, "chunk": 37}, {"cache_max": 0, "chunk": 37}),
         "cached": ({}, {"cache_max": 0, "chunk": 37})}


@pytest.mark.parametrize("path", list(PATHS))
def test_solve_ci_equals_jax(path, monkeypatch):
    """Energy and coefficients to 1e-10 (the same sign convention) on 100
    determinants; the Davidson paths run the same iteration on matvecs equal
    to roundoff."""
    # the JAX package's blocks under jax.jit: the same functions, compiled
    # once per block shape instead of op by op
    monkeypatch.setattr(jham, "hij_dense", jax.jit(jham.hij_dense))
    monkeypatch.setattr(jham, "hij_diagonal", jax.jit(jham.hij_diagonal))
    ts, js = _systems(4, 10, 3, 2)
    space = fci.fci_bits(10, 3, 2)
    kw, jkw = PATHS[path]
    if path == "cached":
        monkeypatch.setattr(solve, "DENSE_MAX", 0)
    e, ci = solve.solve_ci(space, ts.tables("cpu"), ecore=ts.ecore, **kw)
    je, jci = jsolve.solve_ci(space, js.tables, ecore=js.ecore, **jkw)
    assert abs(e - je) < 1e-10, (e, je)
    np.testing.assert_allclose(ci.coeffs, np.asarray(jci.coeffs), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(ci.bits, space)
    assert abs(ci.energy(ts.tables("cpu"), ecore=ts.ecore) - e) < 1e-10


def test_davidson_is_the_jax_iteration_and_finds_the_lowest_eigenpair():
    rng = np.random.default_rng(2)
    n = 60
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2 + np.diag(np.arange(n, dtype=np.float64))
    diag = np.diag(A).copy()
    e, x = solve.davidson(lambda v: A @ v, diag, n, max_subspace=12)
    je, jx = jsolve.davidson(lambda v: A @ v, diag, n, max_subspace=12)
    assert e == je and np.array_equal(x, jx)  # the same numpy iteration
    w, v = np.linalg.eigh(A)
    assert abs(e - w[0]) < 1e-10, (e, w[0])
    assert abs(abs(x @ v[:, 0]) / np.linalg.norm(x) - 1.0) < 1e-10


def test_ci_files_cross_both_ways(tmp_path):
    ts, js = _systems(1, 8, 2, 2)
    space = solve.cisd_space(8, 2, 2)
    e, ci = solve.solve_ci(space, ts.tables("cpu"), ecore=ts.ecore)
    je, jci = jsolve.solve_ci(space, js.tables, ecore=js.ecore)
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    solve.save_ci(p_port, ci, e_var=e, sorb=8, eps1=1e-4)
    jsolve.save_ci(p_jax, jci, e_var=je, sorb=8, eps1=1e-4)
    for reader, path, ref, e_ref in ((jsolve.load_ci, p_port, ci, e),
                                     (solve.load_ci, p_jax, jci, je)):
        got, meta = reader(path)
        np.testing.assert_array_equal(np.asarray(got.bits), np.asarray(ref.bits))
        np.testing.assert_allclose(np.asarray(got.coeffs), np.asarray(ref.coeffs), atol=1e-15)
        assert float(meta["e_var"]) == e_ref and int(meta["sorb"]) == 8
        assert float(meta["eps1"]) == 1e-4
    a, ma = solve.load_ci(p_port)
    b, mb = jsolve.load_ci(p_port)
    assert sorted(ma) == sorted(mb)


@pytest.mark.parametrize("m", [1024, 4096])
def test_repository_hci_spaces_load(m):
    ci, meta = solve.load_ci(os.path.join(ROOT, "checkpoints", f"fe2s2_hci_m{m}.npz"))
    jci, jmeta = jsolve.load_ci(os.path.join(ROOT, "checkpoints", f"fe2s2_hci_m{m}.npz"))
    assert ci.bits.shape == (m, 40) and ci.bits.dtype == np.int8
    assert (ci.bits[:, 0::2].sum(1) == 15).all() and (ci.bits[:, 1::2].sum(1) == 15).all()
    np.testing.assert_array_equal(ci.bits, np.asarray(jci.bits))
    np.testing.assert_allclose(ci.coeffs, np.asarray(jci.coeffs), atol=0)
    assert abs(np.linalg.norm(ci.coeffs) - 1.0) < 1e-12
    assert np.isfinite(float(meta["e_var"])) and float(meta["e_var"]) == float(jmeta["e_var"])
    assert len(np.unique(ci.bits, axis=0)) == m
    jnp.asarray(ci.bits)  # the JAX package takes the port's arrays as they are


def _citrain_setup():
    """(port model, JAX model, its parameters, CI state): the seeded port
    model's weights given to the JAX model; the CISD ground state of a
    random-integral molecule (sorb 8, 2α/2β)."""
    ts, _ = _systems(3, 8, 2, 2)
    tm = GraphMPSRNN(8, 2, 2, dcut=4, dtype=torch.float64, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in tm.named_parameters()}
    _, ci = solve.solve_ci(solve.cisd_space(8, 2, 2), ts.tables("cpu"))
    return tm, JModel(8, 2, 2, dcut=4), params, ci.select(1e-8)


def _max_param_diff(tm, jparams):
    p = dict(tm.named_parameters())
    return max(float(np.abs(p[k].detach().numpy().reshape(np.shape(v)) - np.asarray(v)).max())
               for k, v in jparams.items())


@pytest.mark.parametrize("loss", ["overlap", "lsm", "sample"])
def test_citrain_equals_optax_adam(loss, monkeypatch):
    """Three Adam updates against the JAX package's ``CITrain`` (optax.adam):
    the losses before each update and the parameters after them to 1e-10.
    The "sample" loss takes one fixed draw on both sides (all 36
    determinants, some in the CI set, some dead slots of count 0)."""
    tm, jm, params, ci = _citrain_setup()
    kw = dict(n_iter=3, lr=2e-2, loss=loss, n_sample=1000, capacity=36)
    if loss == "sample":
        bits = fci.fci_bits(8, 2, 2)
        counts = np.random.default_rng(1).integers(0, 40, len(bits))
        counts[::5] = 0
        monkeypatch.setattr(jar, "ar_sampling", lambda *a, **k: (
            jnp.asarray(bits), jnp.asarray(counts), 0))
        monkeypatch.setattr(ci_train, "ar_sampling", lambda *a, **k: (
            torch.as_tensor(bits), torch.as_tensor(counts), 0))
    jp, jhist = JCITrain(jm, ci, JCITrainConfig(**kw)).run(jax.random.PRNGKey(0), params=params)
    tr = ci_train.CITrain(tm, ci, ci_train.CITrainConfig(**kw))
    hist = tr.run(torch.Generator())
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=1e-10)
    assert _max_param_diff(tm, jp) < 1e-10
    assert hist[-1] < hist[0]
    if loss == "overlap":
        assert abs(tr.overlap() - np.sqrt(1.0 - tr.set_loss().item())) < 1e-12
