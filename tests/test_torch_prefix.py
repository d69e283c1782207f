"""The prefix-sharing forward: the t_min helpers against the JAX package,
the port's plain version against the port's flat forward, and the VMC
switch (against the JAX package's plain version and REDUCE: in
``tests/test_torch_prefix_jax.py`` and ``tests/test_torch_prefix_reduce.py``).

Tolerances: f32 mode 1e-5 on log|ψ| and 1e-4 on the unit-circle phase
(both sides are f32 with the same rounding points; sums differ in
order); bf16 mode 1e-4 and 1e-3 (the same rounding points, but an f32
difference of one ulp can move h across a bf16 boundary).  The CUDA
kernels are held against the plain version on the card in
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops import fused_rnn_prefix as jpre
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops import fused_rnn_prefix as pre
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.system import System

SORB, N_EL = 12, 3
BITS = fci.fci_bits(SORB, N_EL, N_EL)  # 400 determinants
TOL = {"f32": (1e-5, 1e-4), "bf16": (1e-4, 1e-3)}


def _pair(dcut, seed, **kw):
    jm = JModel(SORB, N_EL, N_EL, dcut=dcut, dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GraphMPSRNN(SORB, N_EL, N_EL, dcut=dcut, dtype=torch.float32, device="cpu", **kw)
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


def _family(B, C, seed):
    """Parents from the FCI space and children drawn from it: generic
    t_min patterns, t_min = 0 included; child 0 equals its parent
    (t_min = norb)."""
    rng = np.random.default_rng(seed)
    parents = BITS[rng.integers(0, len(BITS), size=B)]
    kids = BITS[rng.integers(0, len(BITS), size=(B, C))]
    kids[:, 0] = parents
    return parents, kids


def _close(out, ref, tol):
    out, ref = np.asarray(out).reshape(-1, 2), np.asarray(ref).reshape(-1, 2)
    np.testing.assert_allclose(out[:, 0], ref[:, 0], atol=tol[0], rtol=0)
    d = np.abs(np.exp(1j * out[:, 1]) - np.exp(1j * ref[:, 1]))
    assert d.max() < tol[1], d.max()


def test_t_min_helpers_match_jax():
    """t_min_process_order, t_min_from_packed and sort_children_by_t_min
    give JAX's integers exactly (a permuted site order included)."""
    order = [3, 0, 5, 1, 4, 2]
    edges = [(order[t - 1], order[t]) for t in range(1, 6)]
    from pynqs_tpu_torch.models.graph_mps_rnn import graph_from_edges
    from pynqs_tpu.models.graph_mps_rnn import graph_from_edges as jgraph

    jm = JModel(SORB, N_EL, N_EL, dcut=4, graph=jgraph(6, edges, order))
    tm = GraphMPSRNN(SORB, N_EL, N_EL, dcut=4, graph=graph_from_edges(6, edges, order),
                     device="cpu")
    parents, kids = _family(7, 11, 0)
    want = np.asarray(jpre.t_min_process_order(jm, jnp.asarray(parents), jnp.asarray(kids)))
    got = pre.t_min_process_order(tm, torch.as_tensor(parents), torch.as_tensor(kids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 6).any() and (want == 0).any()

    rng = np.random.default_rng(1)
    orbs = rng.integers(0, SORB, size=(5, 9, 4))
    for ow in (7, 8):
        op = orbs[..., 0] | orbs[..., 1] << ow | orbs[..., 2] << 2 * ow | orbs[..., 3] << 3 * ow
        if ow == 7:  # the slim packing carries H's sign in bit 28
            op = op | (rng.integers(0, 2, size=op.shape) << 28)
        op = op.astype(np.int32)
        want = np.asarray(jpre.t_min_from_packed(jm, jnp.asarray(op), ow))
        got = pre.t_min_from_packed(tm, torch.as_tensor(op), ow)
        np.testing.assert_array_equal(got.numpy(), want)

    tmin = rng.integers(0, 7, size=(4, 13)).astype(np.int32)
    cb = rng.integers(0, 2, size=(4, 13, SORB)).astype(np.int8)
    jb, jt, ji = jpre.sort_children_by_t_min(jnp.asarray(cb), jnp.asarray(tmin))
    tb, tt, ti = pre.sort_children_by_t_min(torch.as_tensor(cb), torch.as_tensor(tmin))
    for a, b in ((tb, jb), (tt, jt), (ti, ji)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_prefix_plain_matches_flat_plain(mm):
    """The same rows through the port's flat plain version; no launch is
    counted for CPU rows."""
    tm = GraphMPSRNN(SORB, N_EL, N_EL, dcut=12, phase_mode="arg", norm_mode="mpsrnn",
                     dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    parents, kids = _family(5, 17, 4)
    p, k = torch.as_tensor(parents), torch.as_tensor(kids)
    tmin = pre.t_min_process_order(tm, p, k)
    dt = torch.float32 if mm == "f32" else torch.bfloat16
    before = (pre.PARENT_LAUNCHES.n, pre.CHILD_LAUNCHES.n)
    lp_p, lp_c = pre.graph_mpsrnn_logpsi_fused_prefix(tm, p, k, tmin, matmul_dtype=dt)
    assert (pre.PARENT_LAUNCHES.n, pre.CHILD_LAUNCHES.n) == before
    flat = fused_rnn.graph_mpsrnn_logpsi_fused(
        tm, torch.cat([p, k.reshape(-1, SORB)]), matmul_dtype=dt)
    _close(lp_p.numpy(), flat[:5].numpy(), TOL[mm])
    _close(lp_c.numpy(), flat[5:].numpy(), TOL[mm])


def _systems(seed=0):
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((SORB, SORB)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(SORB)) * 0.02
    return (JSystem.from_integrals(h1e, h2e, SORB, N_EL, N_EL, dtype=np.float64),
            System.from_integrals(h1e, h2e, SORB, N_EL, N_EL))


def _vmc(model, ts, prefix, mm="f32"):
    sampler = ARSampler(SORB, N_EL, N_EL, n_sample=5000, capacity=64)
    # the flat steps take the fused forward, as the prefix steps do (by
    # default a model on the CPU takes model.log_psi)
    cfg = VMCConfig(lr=0.01, eloc_method="reduce", eloc_k_det=20, eloc_n_stoch=8,
                    eloc_topk="segmax", fused_forward=True, fused_matmul_dtype=mm,
                    eloc_prefix=prefix)
    return VMC(model, ts, sampler, cfg)


def _chain(seed=5):
    return GraphMPSRNN(SORB, N_EL, N_EL, dcut=6, phase_mode="arg", norm_mode="mpsrnn",
                       dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def test_vmc_step_with_eloc_prefix_matches_flat():
    """Same generator: the same samples, tail draws and children, so the
    step's energy agrees to the forwards' f32 rounding (1e-5) and the
    updated parameters agree to 1e-6."""
    _, ts = _systems(2)
    outs, params = [], []
    for prefix in (False, True):
        model = _chain()
        vmc = _vmc(model, ts, prefix)
        assert (vmc._eloc_prefix_fwd() is not None) == prefix
        outs.append(vmc.step(torch.Generator().manual_seed(7), 1.0))
        params.append({k: v.detach().clone() for k, v in model.named_parameters()})
    assert outs[0]["w_sum"].item() == pytest.approx(1.0, abs=1e-6)  # f32 weights
    assert abs(outs[0]["energy"].item() - outs[1]["energy"].item()) < 1e-5
    assert outs[0]["n_unique"].item() == outs[1]["n_unique"].item()
    for k in params[0]:
        np.testing.assert_allclose(params[1][k].numpy(), params[0][k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_eloc_prefix_on_a_dag_takes_the_flat_path():
    """As in the JAX package: no prefix forward for a DAG model (nor for
    tensor coupling), and the step runs on the flat forward."""
    _, ts = _systems(2)
    dag = GraphMPSRNN(SORB, N_EL, N_EL, dcut=4, graph=grid_snake_graph(3, 2),
                      use_tensor=True, phase_mode="arg", norm_mode="mpsrnn",
                      dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert not pre.prefix_available(dag) and pre.prefix_available(_chain())
    with pytest.raises(ValueError, match="chain"):
        pre.ReducePrefixForward(dag)
    rows = torch.as_tensor(BITS[:3])
    with pytest.raises(ValueError, match="chain"):
        pre.prefix_parent(dag, rows)
    with pytest.raises(ValueError, match="chain"):
        pre.prefix_child(dag, rows, torch.zeros(3), torch.zeros(3), None, None)
    vmc = _vmc(dag, ts, True)
    assert vmc._eloc_prefix_fwd() is None
    out = vmc.step(torch.Generator().manual_seed(1), 1.0)
    assert np.isfinite(out["energy"].item())
