"""Port parity of the other ansätze: every model's ``log_psi`` and its
gradients against the JAX package on the same parameters and rows (f64),
and the parameter-tree plumbing they share (``utils/tree.py``).

The parameters are the port model's seeded draw, moved off its init and
handed to both packages (the port through ``load_numpy_params``); the
layout test holds the tree to the JAX model's ``init`` (by
``jax.eval_shape``: compiling the JAX init's random draws costs seconds
per model).  The JAX reference runs under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynqs_tpu import models as jm
from pynqs_tpu.models import extra as jextra
from pynqs_tpu.models import mps as jmps
from pynqs_tpu.utils import mps_import as jmps_import
from pynqs_tpu.utils import fci

from pynqs_tpu_torch import models as tm
from pynqs_tpu_torch.models import mps as tmps
from pynqs_tpu_torch.models.base import Ansatz, ARAnsatz
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.utils.tree import (
    flatten_tree,
    tree_named_parameters,
    tree_order,
    unflatten_tree,
)

SORB, NOA, NOB = 6, 1, 1
ROWS = fci.fci_bits(SORB, NOA, NOB)  # 9 determinants
CPU = dict(device="cpu")
# the references are traced and compiled once per case; the backend's
# optimization passes cost more than the run saves at these sizes
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

RBM_VARIANTS = [(pt, act) for pt in ("real", "complex") for act in ("cosh", "cos", "tanh")]
NORMS = ("softmax-log", "norm", "norm-abs", "softmax-sign")
PMODES = ("element", "linear", "conv", "spm")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and under the test
    runner's parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(case):
    """(JAX model, port model) of one case at a small size."""
    kind, _, opt = case.partition(":")
    if kind == "rbm":
        pt, act = opt.split("-")
        kw = dict(alpha=2, param_type=pt, activation=act, init_scale=0.3)
        return jm.RBM(SORB, **kw), tm.RBM(SORB, **kw, **CPU)
    if kind == "jastrow":
        return jextra.Jastrow(SORB), tm.Jastrow(SORB, **CPU)
    if kind == "ising":
        return (jextra.IsingRBM(SORB, alpha=1, param_type=opt),
                tm.IsingRBM(SORB, alpha=1, param_type=opt, **CPU))
    if kind == "dbm":
        return jextra.DBM(SORB, nh1=6, nh2=5), tm.DBM(SORB, nh1=6, nh2=5, **CPU)
    if kind == "arrbm":
        return (jm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5),
                tm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5, **CPU))
    if kind == "arrbm2":
        return (jm.ARRBM2(SORB, NOA, NOB, nh=6, phase_hidden=5),
                tm.ARRBM2(SORB, NOA, NOB, nh=6, phase_hidden=5, **CPU))
    if kind == "rnn":
        return (jm.RNNWavefunction(SORB, NOA, NOB, hidden=6, phase_hidden=5),
                tm.RNNWavefunction(SORB, NOA, NOB, hidden=6, phase_hidden=5, **CPU))
    if kind == "decoder":
        kw = dict(n_layer=2, n_head=2, d_model=8, phase_hidden=5, norm_method=opt)
        return (jm.DecoderWavefunction(SORB, NOA, NOB, **kw),
                tm.DecoderWavefunction(SORB, NOA, NOB, **kw, **CPU))
    if kind == "mpsdec":
        kw = dict(dcut=3, n_layer=1, n_head=2, d_model=8, pmode=opt)
        return jm.MPSDecoder(SORB, NOA, NOB, **kw), tm.MPSDecoder(SORB, NOA, NOB, **kw, **CPU)
    if kind == "mps":
        return jmps.MPSWavefunction(SORB, dcut=3), tm.MPSWavefunction(SORB, dcut=3, **CPU)
    if kind == "hybrid":
        return (jextra.HybridWavefunction(jm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5),
                                          jm.RBM(SORB, alpha=1, param_type="real")),
                tm.HybridWavefunction(tm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5, **CPU),
                                      tm.RBM(SORB, alpha=1, param_type="real", **CPU)))
    if kind == "multipsi":
        return (jextra.MultiPsi(jm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5),
                                jextra.Jastrow(SORB)),
                tm.MultiPsi(tm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5, **CPU),
                            tm.Jastrow(SORB, **CPU)))
    if kind == "spinproj":
        return (jextra.SpinProjected(jm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5), -1),
                tm.SpinProjected(tm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5, **CPU), -1))
    raise ValueError(case)


# forward only: the gradient's trace and compile double the JAX side's
# cost, and these share their backward with a case that has it (the other
# softmax and norm method, the element and spm modulations)
FORWARD_ONLY = ("decoder:norm-abs", "decoder:softmax-sign", "mpsdec:linear", "mpsdec:conv")
CASES = ([f"rbm:{pt}-{act}" for pt, act in RBM_VARIANTS] + ["jastrow", "ising:real",
         "ising:complex", "dbm", "arrbm", "arrbm2", "rnn"]
         + [f"decoder:{n}" for n in NORMS] + [f"mpsdec:{p}" for p in PMODES]
         + ["mps", "hybrid", "multipsi", "spinproj"])


def _params(model, seed, scale=0.2):
    """The port model's parameters as a JAX-layout numpy tree, each leaf
    moved off its init (zeros, ones, identities) so that every gradient is
    generic."""
    rng = np.random.default_rng(seed)
    return unflatten_tree({k: p.detach().numpy() + scale * rng.standard_normal(tuple(p.shape))
                           for k, p in tree_named_parameters(model).items()})


@pytest.mark.parametrize("case", CASES)
def test_log_psi_and_gradients_match_jax(case):
    """log|ψ| to 1e-10 and arg ψ to 1e-9 mod 2π on the sector's rows;
    the gradients of Σ log|ψ| and Σ arg ψ to 1e-8 (but ``FORWARD_ONLY``)."""
    jmodel, model = _pair(case)
    params = _params(model, len(case))
    model.load_numpy_params(params)

    grads = case not in FORWARD_ONLY

    def ref(p, b):
        lp = jmodel.log_psi(p, b)
        return lp, jax.jacrev(lambda q: jmodel.log_psi(q, b).sum(0))(p) if grads else None

    args = (jax.tree.map(jnp.asarray, params), jnp.asarray(ROWS))
    jlp, jgrad = jax.jit(ref).lower(*args).compile(FAST_COMPILE)(*args)
    lp = model.log_psi(torch.as_tensor(ROWS))
    got, want = lp.detach().numpy(), np.asarray(jlp)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-10, rtol=0)
    dph = np.angle(np.exp(1j * (got[:, 1] - want[:, 1])))
    assert np.abs(dph).max() <= 1e-9, np.abs(dph).max()

    if not grads:
        return
    named = tree_named_parameters(model)
    jg = flatten_tree(jgrad)
    assert set(jg) == set(named)
    for c in (0, 1):
        grads = torch.autograd.grad(lp[:, c].sum(), list(named.values()), allow_unused=True,
                                    retain_graph=c == 0)
        for (k, p), g in zip(named.items(), grads):
            g = torch.zeros_like(p) if g is None else g
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k])[c], atol=1e-8, rtol=0,
                                       err_msg=f"{k} ({('log|psi|', 'arg')[c]})")


@pytest.mark.parametrize("case", ["rbm:complex-cosh", "decoder:softmax-log", "mpsdec:linear",
                                  "multipsi", "spinproj"])
def test_parameter_names_are_the_jax_tree_paths(case):
    """The port's parameters are named by their paths in the JAX tree, a
    wrong tree raises, and the port's tree goes back to the JAX layout."""
    jmodel, model = _pair(case)
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    flat = flatten_tree(tree)
    named = tree_named_parameters(model)
    assert set(named) == set(flat)
    for k, p in named.items():
        assert tuple(p.shape) == flat[k].shape, k
    back = unflatten_tree({k: p.detach().numpy() for k, p in named.items()})
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert tree_order(named) == list(flat)
    bad = {k: np.zeros(v.shape) for k, v in flat.items()}
    bad.pop(next(iter(bad)))
    with pytest.raises(KeyError, match="parameter keys differ"):
        model.load_numpy_params(unflatten_tree(bad))


def test_models_follow_the_contract():
    """Each model is an ``Ansatz``, each AR model an ``ARAnsatz`` with the
    JAX model's sites per step; ``forward`` is ``log_psi``."""
    for case in CASES:
        jmodel, model = _pair(case)
        assert isinstance(model, Ansatz), case
        ar = hasattr(jmodel, "ar_step") and getattr(jmodel, "sites_per_step", None)
        assert isinstance(model, ARAnsatz) == bool(ar), case
        if ar:
            assert model.sites_per_step == jmodel.sites_per_step, case
        b = torch.as_tensor(ROWS[:3])
        assert torch.equal(model(b), model.log_psi(b)), case
    assert isinstance(GraphMPSRNN(SORB, NOA, NOB, dcut=2, **CPU), ARAnsatz)


def test_flat_trees_keep_their_layout():
    """A flat tree (``GraphMPSRNN``'s) round-trips to the same dict, in
    insertion order, and sorts as ``sorted``."""
    named = {k: np.zeros(1) for k in ("M_re", "v_im", "eta", "global_phase", "c_arg_re")}
    back = unflatten_tree(named)
    assert list(back) == list(named)
    assert tree_order(named) == sorted(named)


def test_focus_files_match_jax(tmp_path):
    """A converted FOCUS state dict written here with ``torch.save`` (4
    sites, bond dimension 3, the boundary M last, ``module.`` prefixes, in
    a ``{"model": ...}`` wrapping): ``exact_mps_from_focus`` gives the JAX
    package's padded tensors, and the model evaluates them as the JAX
    model does (held by the "mps" case above); ``focus_trial_log_psi`` is
    the chain ``GraphMPSRNN`` the JAX package builds (the file's bond
    dimension, arg phase, mpsrnn norm) with the JAX import's parameters."""
    rng = np.random.default_rng(7)
    norb, D = 4, 3
    sites = [torch.as_tensor(rng.standard_normal((4, D, D, 2))) for _ in range(norb - 1)]
    sites.append(torch.as_tensor(rng.standard_normal((4, D, 1, 2))))
    sd = {"module.params_M.all_sites": sites,
          "module.params_w.all_sites": torch.as_tensor(rng.standard_normal((norb, D, 2))),
          "module.params_c.all_sites": torch.as_tensor(rng.standard_normal((norb, 2)))}
    path = str(tmp_path / "focus.pth")
    torch.save({"model": sd}, path)
    rows = torch.as_tensor(fci.fci_bits(2 * norb, 2, 2))

    model, params = tmps.exact_mps_from_focus(path, device="cpu")
    jmodel, jparams = jmps.exact_mps_from_focus(path)
    assert model.dcut == jmodel.dcut == D and set(params) == set(jparams)
    for k, p in tree_named_parameters(model).items():
        np.testing.assert_array_equal(params[k], np.asarray(jparams[k]), err_msg=k)
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jparams[k]), err_msg=k)

    trial = tmps.focus_trial_log_psi(path, 2, 2, dtype=torch.float64, device="cpu")
    ref = GraphMPSRNN(2 * norb, 2, 2, dcut=D, phase_mode="arg", norm_mode="mpsrnn", **CPU)
    jref = jm.GraphMPSRNN(2 * norb, 2, 2, dcut=D, phase_mode="arg", norm_mode="mpsrnn")
    ref.load_numpy_params(jmps_import.load_focus_mpsrnn(path, jref))
    assert torch.equal(trial(rows), ref.log_psi(rows).detach())
