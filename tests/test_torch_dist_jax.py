"""Data parallelism against the JAX package (f64 on the CPU), and the
entry point's energy.

The pair-form energy and gradient on 40 fixed rows (weights with dead
rows whose local energies are NaN), split over two gloo ranks, against
the JAX package's ``energy_and_grad`` on all 40 rows with the same
parameters (drawn in the port, handed to JAX), to 1e-10.  The JAX side
runs on one device: no JAX mesh is built.  And ``entry()``'s ``fn`` on
the CPU against the JAX package's ``entry()`` ``fn`` with the JAX
parameters carried over: on the Hartree–Fock rows of the Hubbard chain
only the k_det largest terms are nonzero, so the tail adds nothing and
the two generators' different draws do not matter; both are f32
(JAX's model.log_psi, the port's plain fused forward), to 1e-5.  And
``run_ranks`` when a rank fails: it raises with the failed ranks'
tracebacks (the other rank fails in its collective) and stops them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.grad.energy_grad import energy_and_grad as jgrad
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.entry import entry
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.parallel import run_ranks

from torch_dist_ranks import fail_on_rank_one, grad_scenario

KW = dict(phase_mode="arg", norm_mode="mpsrnn")


def test_dp_energy_and_grad_equal_jax(tmp_path):
    tm = GraphMPSRNN(12, 3, 3, dcut=5, device="cpu", generator=torch.Generator().manual_seed(3),
                     **KW)
    params = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    rng = np.random.default_rng(0)
    bits = fci.fci_bits(12, 3, 3)[rng.permutation(400)[:40]]
    w = rng.random(40)
    w[::6] = 0.0
    w /= w.sum()
    eloc = rng.standard_normal((40, 2))
    eloc[w == 0] = np.nan
    case = {"model_kw": KW, "params": params, "bits": bits, "w": w, "eloc": eloc}
    ranks = run_ranks(grad_scenario, 2, backend="gloo", device="cpu", args=(case,),
                      timeout=120, rendezvous_dir=str(tmp_path), num_threads=1)
    jm = JModel(12, 3, 3, dcut=5, **KW)
    je, jg, jv = jgrad(jm, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(bits),
                       jnp.asarray(w), jnp.asarray(eloc))
    for r in ranks:
        np.testing.assert_allclose(r["e"], np.asarray(je), atol=1e-10, rtol=0)
        np.testing.assert_allclose(r["var"], float(jv), atol=1e-10, rtol=0)
        assert set(r["grads"]) == set(jg)
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, np.asarray(jg[k]), atol=1e-10, rtol=0, err_msg=k)
    for k in jg:  # the ranks' gradients are equal bit for bit
        np.testing.assert_array_equal(ranks[0]["grads"][k], ranks[1]["grads"][k])


def test_entry_fn_equals_the_jax_entry_fn():
    import importlib

    jentry = importlib.import_module("__graft_entry__").entry
    jfn, (jparams, jbits) = jentry()
    fn, (model, bits) = entry(device="cpu")
    model.load_numpy_params({k: np.asarray(v) for k, v in jparams.items()})
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    want = float(jax.jit(jfn)(jparams, jbits))
    got = float(fn(model, bits))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_run_ranks_raises_and_stops_the_ranks_when_one_fails(tmp_path):
    with pytest.raises(RuntimeError, match="--- rank 1 ---(.|\n)*rank 1 fails"):
        run_ranks(fail_on_rank_one, 2, backend="gloo", device="cpu", timeout=60,
                  rendezvous_dir=str(tmp_path), num_threads=1)
