"""Port parity: ``GraphMPSRNN.log_psi`` against the JAX model in f64.

Same parameters (the JAX tree loaded through ``load_numpy_params``),
same rows; log|ψ| and arg ψ agree to 1e-10."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.utils.checkpoint import load_params, params_from_numpy

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "fe2s2_dcut48_final.pkl")


def _pair(jkw, dtype=torch.float64, key=0, **kw):
    dag = kw.pop("dag", False)
    jm = JModel(graph=jgrid(3, 2) if dag else None, **jkw, **kw)
    params = jm.init(jax.random.PRNGKey(key))
    tm = GraphMPSRNN(graph=grid_snake_graph(3, 2) if dag else None, device="cpu",
                     dtype=dtype, **jkw, **kw)
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


@pytest.mark.parametrize("phase_mode", ["arg", "linear"])
@pytest.mark.parametrize("norm_mode", ["mpsrnn", "unit"])
@pytest.mark.parametrize("graph", ["chain", "dag", "tensor"])
def test_log_psi_matches_jax(phase_mode, norm_mode, graph):
    jm, params, tm = _pair(
        dict(sorb=12, noa=3, nob=3, dcut=6), dag=graph != "chain",
        use_tensor=graph == "tensor", dcut_cmpr=3,
        phase_mode=phase_mode, norm_mode=norm_mode, key=len(graph),
    )
    bits = fci.fci_bits(12, 3, 3)
    ref = np.asarray(jm.log_psi(params, jnp.asarray(bits)))
    out = tm.log_psi(torch.as_tensor(bits)).detach().numpy()
    assert out.shape == (bits.shape[0], 2)
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)
    # single-row form
    one = tm.log_psi(torch.as_tensor(bits[3])).detach().numpy()
    np.testing.assert_allclose(one, ref[3], atol=1e-10, rtol=0)


def test_fe2s2_checkpoint_loads_and_matches_jax():
    """The in-repo dcut-48 Fe2S2 chain (sorb 40, 15α/15β) loads as it is
    and gives the JAX log ψ on 16 rows (phase mod 2π)."""
    tree = load_params(CKPT)
    jm = JModel(40, 15, 15, dcut=48, phase_mode="arg", norm_mode="mpsrnn",
                dtype=jnp.float64)
    tm = GraphMPSRNN(40, 15, 15, dcut=48, phase_mode="arg", norm_mode="mpsrnn",
                     device="cpu").load_numpy_params(tree)
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in tree.items()}
    rng = np.random.default_rng(0)
    bits = np.zeros((16, 40), np.int8)
    for r in range(16):
        bits[r, 2 * rng.permutation(20)[:15]] = 1
        bits[r, 2 * rng.permutation(20)[:15] + 1] = 1
    ref = np.asarray(jm.log_psi(jp, jnp.asarray(bits)))
    out = tm.log_psi(torch.as_tensor(bits)).detach().numpy()
    np.testing.assert_allclose(out[:, 0], ref[:, 0], atol=1e-10, rtol=0)
    d = np.abs(np.exp(1j * out[:, 1]) - np.exp(1j * ref[:, 1]))
    assert d.max() < 1e-10, d.max()
    t = params_from_numpy(tree, device="cpu")
    assert set(t) == set(dict(tm.named_parameters()))
    assert t["M_re"].dtype == torch.float32 and t["M_re"].shape == (20, 1, 4, 48, 48)


def test_ar_step_conditionals_match_log_psi():
    """Teacher-forcing the AR steps along each row reproduces log|ψ|."""
    tm = GraphMPSRNN(12, 3, 3, dcut=5, graph=grid_snake_graph(3, 2), use_tensor=True,
                     dcut_cmpr=2, device="cpu", generator=torch.Generator().manual_seed(0))
    from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_two_site

    bits = torch.as_tensor(fci.fci_bits(12, 3, 3))
    with torch.no_grad():
        carry = tm.ar_init(bits.shape[0])
        vals = bits[:, 0::2].long() + 2 * bits[:, 1::2].long()
        prev = torch.zeros(bits.shape[0], dtype=torch.long)
        ua = torch.zeros_like(prev)
        ub = torch.zeros_like(prev)
        la = torch.zeros(bits.shape[0], dtype=torch.float64)
        for k, s in enumerate(tm.site_order):
            logp, carry = tm.ar_step(carry, k, prev)
            rem = tm.norb - k - 1
            logp = apply_mask_logp(logp, mask_two_site(ua, ub, 3, 3, rem, rem))
            x = vals[:, s]
            la += 0.5 * logp.gather(1, x[:, None])[:, 0]
            ua, ub, prev = ua + (x & 1), ub + (x >> 1), x
        ref = tm.log_psi(bits)[:, 0]
    np.testing.assert_allclose(la.numpy(), ref.numpy(), atol=1e-12, rtol=0)
    # normalized over the sector
    assert abs(np.exp(2 * ref.numpy()).sum() - 1.0) < 1e-10
