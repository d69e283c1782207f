"""The DMRG warm starts against the JAX package, in f64 on the CPU:
``utils/focus_ctns`` (a raw FOCUS CTNS binary written by the port's
``write_ctns_sites``, with seeded block-sparse sectors) and
``mps_import.load_renormalizer_mpsrnn`` (a torch-saved list of 1-site
tensors): the dense sites, the converted structure and the parameter
trees bit for bit, and the warm-started ``log_psi`` within 1e-12; and
the slice as a whole, a chain at sorb 12 warm-started from a
test-written converted FOCUS file and one exact-sampler ``VMC.step``
(AdamW at the DMRG script's lr 2e-4, clip 0.1) against the JAX step,
energy within 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.optim.vmc import VMC as JVMC
from pynqs_tpu.optim.vmc import VMCConfig as JCfg
from pynqs_tpu.sampler.exact import ExactSampler as JExact
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import focus_ctns as jfocus
from pynqs_tpu.utils import mps_import as jimport
from pynqs_tpu.utils.fci import fci_bits

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.exact import ExactSampler
from pynqs_tpu_torch.utils import focus_ctns, mps_import
from pynqs_tpu_torch.utils.system import System


def _bonds(norb, dmax):
    return [min(4 ** t, 4 ** (norb - t), dmax) for t in range(norb + 1)]


def random_ctns(norb, dmax, seed, zero_frac=0.3):
    """Dense sites [l, 4, r] with sectors of at most 3 states and about
    ``zero_frac`` of the blocks zero, and the sectors (row, col, mid)."""
    rng = np.random.default_rng(seed)
    D = _bonds(norb, dmax)

    def cut(n):
        out = []
        while n:
            out.append(min(n, int(rng.integers(1, 4))))
            n -= out[-1]
        return out

    parts = [cut(d) for d in D]
    sites, sectors = [], []
    for t in range(norb):
        x = rng.standard_normal((D[t], 4, D[t + 1])) / np.sqrt(D[t])
        o_r = np.concatenate([[0], np.cumsum(parts[t])])
        o_c = np.concatenate([[0], np.cumsum(parts[t + 1])])
        for i in range(len(parts[t])):
            for j in range(len(parts[t + 1])):
                for m in range(4):
                    if rng.random() < zero_frac:
                        x[o_r[i]:o_r[i + 1], m, o_c[j]:o_c[j + 1]] = 0
        sites.append(x)
        sectors.append((parts[t], parts[t + 1], [1, 1, 1, 1]))
    return sites, sectors


def _models(norb, dcut):
    kw = dict(dcut=dcut, phase_mode="arg", norm_mode="mpsrnn")
    n = norb // 2
    return (JModel(2 * norb, n, n, dtype=jnp.float64, **kw),
            GraphMPSRNN(2 * norb, n, n, dtype=torch.float64, device="cpu", **kw))


def _same_tree(jtree, tree):
    assert set(jtree) == set(tree)
    for k in tree:
        a, b = np.asarray(jtree[k], np.float64), np.asarray(tree[k], np.float64)
        assert a.shape == b.shape and np.array_equal(a, b), k


def _same_log_psi(jm, jtree, model, tree, n_rows=200):
    model.load_numpy_params(tree)
    bits = fci_bits(model.sorb, model.noa, model.nob)[:n_rows]
    want = np.asarray(jm.log_psi(jax.tree.map(jnp.asarray, jtree), jnp.asarray(bits)))
    got = model.log_psi(torch.as_tensor(bits)).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-12, rtol=0)
    assert np.abs(np.exp(1j * got[:, 1]) - np.exp(1j * want[:, 1])).max() < 1e-12


def test_raw_ctns_binary_equals_the_jax_reader(tmp_path):
    sites, sectors = random_ctns(6, 10, 0)
    path = str(tmp_path / "rcanon_isweep1.bin")
    focus_ctns.write_ctns_sites(path, sites, sectors)
    got, want = focus_ctns.read_ctns_sites(path), jfocus.read_ctns_sites(path)
    assert len(got) == len(want) == 6
    for a, b, s in zip(got, want, sites):
        assert np.array_equal(a, b) and np.array_equal(a, s)
    sd, jsd = focus_ctns.ctns_state_dict(got), jfocus.ctns_state_dict(want)
    for k in ("params_w.all_sites", "params_c.all_sites"):
        assert np.array_equal(sd[k], jsd[k])
    assert all(np.array_equal(a, b) for a, b in zip(sd["params_M.all_sites"],
                                                    jsd["params_M.all_sites"]))
    jm, model = _models(6, 12)
    tree = focus_ctns.load_focus_ctns_mpsrnn(path, model)
    jtree = jfocus.load_focus_ctns_mpsrnn(path, jm)
    _same_tree(jtree, tree)
    _same_log_psi(jm, jtree, model, tree)


def test_renormalizer_warm_start_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    D = [1, 2, 4, 6, 8, 8, 6, 4, 2, 1, 1]  # bonds of 10 spin orbitals, trailing 1
    ts = [rng.standard_normal((D[i], 2, D[i + 1])) / 2 for i in range(10)]
    path = str(tmp_path / "renormalizer_mps.pth")
    torch.save([torch.as_tensor(t) for t in ts], path)
    jm, model = _models(5, 8)
    tree = mps_import.load_renormalizer_mpsrnn(path, model)
    jtree = jimport.load_renormalizer_mpsrnn(path, jm)
    _same_tree(jtree, tree)
    _same_tree(jtree, mps_import.load_renormalizer_mpsrnn(ts, model))
    _same_log_psi(jm, jtree, model, tree)
    with pytest.raises(ValueError, match="even number"):
        mps_import.load_renormalizer_mpsrnn(ts[:3], model)


def test_warm_started_step_matches_jax(tmp_path):
    """A converted FOCUS file (the torch state dict the JAX script reads)
    of a seeded bond-6 state, loaded by both packages' load_focus_mpsrnn
    into a dcut-8 chain on 6 sites; one exact-sampler step with AdamW
    (2e-4, clip 0.1, SIMPLE eloc) on seeded integrals."""
    sites, _ = random_ctns(6, 6, 2)
    sd = focus_ctns.ctns_state_dict(sites)
    path = str(tmp_path / "fe2s2-like-focus.pth")
    torch.save({"params_M.all_sites": [torch.as_tensor(m) for m in sd["params_M.all_sites"]],
                "params_w.all_sites": torch.as_tensor(sd["params_w.all_sites"]),
                "params_c.all_sites": torch.as_tensor(sd["params_c.all_sites"])}, path)
    jm, model = _models(6, 8)
    tree = mps_import.load_focus_mpsrnn(path, model)
    jtree = jimport.load_focus_mpsrnn(path, jm)
    _same_tree(jtree, tree)
    model.load_numpy_params(tree)
    rng = np.random.default_rng(3)
    h1 = rng.standard_normal((12, 12)) * 0.2
    h1 = (h1 + h1.T) / 2
    h2 = rng.standard_normal(triangle_size(12)) * 0.05
    system = System.from_integrals(h1, h2, 12, 3, 3, 1.5)
    jsystem = JSystem.from_integrals(h1, h2, 12, 3, 3, 1.5)
    cfg = VMCConfig(lr=2e-4, optimizer="adamw", clip_grad=0.1)
    out = VMC(model, system, ExactSampler(12, 3, 3), cfg).step(torch.Generator().manual_seed(0),
                                                               cfg.clip_grad)
    tx = optax.adamw(2e-4)
    jv = JVMC(jm, jsystem, JExact(12, 3, 3), JCfg(optimizer=tx, clip_grad=0.1))
    jp = jax.tree.map(jnp.asarray, jtree)
    res = jv._step(jp, tx.init(jp), jax.random.PRNGKey(0), None, jnp.asarray(0.1), None)
    assert np.isfinite(float(out["energy"]))
    assert abs(float(out["energy"]) - float(res[3])) < 1e-10
    assert abs(float(out["gnorm"]) - float(res[7])) < 1e-10
    assert abs(float(out["w_sum"]) - 1.0) < 1e-12
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    for k, v in res[0].items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-10, rtol=0, err_msg=k)
