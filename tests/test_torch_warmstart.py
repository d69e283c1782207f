"""Port parity of the warm starts and the molecule-file reader against
the JAX package: ``grow_dcut`` and ``structural_warm_start`` (the JAX
model's fresh init replaced by the port model's own, so both draw the
same one), ``load_focus_mpsrnn`` on a state dict written here with
``torch.save``, and ``System.from_pth`` on a ``.pth`` written here."""

import os

import numpy as np
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.ops.integrals import precompute_hij_tables as jtables
from pynqs_tpu.utils import mps_import as jmi
from pynqs_tpu.utils.system import System as JSystem

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils import flagship
from pynqs_tpu_torch.utils import mps_import as tmi
from pynqs_tpu_torch.utils.system import System


def _pair(dcut, seed=0, **kw):
    """A JAX model and the port's of the same configuration (``graph``:
    the 2x2 snake grid), and a parameter tree of the port's init rule."""
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("graph"):
        tkw["graph"], jkw["graph"] = grid_snake_graph(2, 2), jgrid(2, 2)
    jm = JModel(8, 2, 2, dcut=dcut, **jkw)
    tm = GraphMPSRNN(8, 2, 2, dcut=dcut, device="cpu", **tkw)
    return jm, tm, tm.init_params(torch.Generator().manual_seed(100 + seed))


def _equal_trees(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(phase_mode="arg", norm_mode="mpsrnn"),
    dict(phase_mode="linear", norm_mode="unit"),
    dict(phase_mode="arg", norm_mode="mpsrnn", use_tensor=True, dcut_cmpr=2, graph=True),
], ids=["chain-arg-mpsrnn", "chain-linear-unit", "dag-tensor"])
def test_grow_dcut_equals_jax(kw, monkeypatch):
    """dcut 3 → 5: the old blocks (divided by γ where they read a hidden
    under the mpsrnn gauge), the fresh padding at 1e-3 × init, the phase
    readouts padded with exact zeros; the same tree in both packages."""
    jm_old, tm_old, p_old = _pair(3, **kw)
    jm_new, tm_new, _ = _pair(5, seed=1, **kw)
    init = tm_new.init_params(torch.Generator().manual_seed(11))
    monkeypatch.setattr(JModel, "init", lambda self, key: init)
    got = tmi.grow_dcut(p_old, tm_old, tm_new)
    _equal_trees(got, jmi.grow_dcut(p_old, jm_old, jm_new))
    # the default generator is the one seeded 11
    _equal_trees(got, tmi.grow_dcut(p_old, tm_old, tm_new,
                                    generator=torch.Generator().manual_seed(11)))
    for k in ("w_arg_re", "w_arg_im", "w_ph", "c_ph"):
        if k in got:  # the padded phase readouts stay exactly 0
            pad = got[k].copy()
            pad[tuple(slice(0, n) for n in p_old[k].shape)] = 0
            assert not pad.any(), k
    tm_new.load_numpy_params(got)  # loads as it is


def test_structural_warm_start_equals_jax(monkeypatch):
    """A trained chain tree into the DAG model with tensor coupling: the
    shared tensors carried over, the grown M (2 predecessor slots) in its
    leading corner, K/U at 1e-2 × init; float32 in both packages."""
    _, _, p_chain = _pair(4, phase_mode="arg", norm_mode="mpsrnn")
    kw = dict(phase_mode="arg", norm_mode="mpsrnn", use_tensor=True, dcut_cmpr=2)
    jm = JModel(8, 2, 2, dcut=4, graph=jgrid(2, 2), **kw)
    tm = GraphMPSRNN(8, 2, 2, dcut=4, graph=grid_snake_graph(2, 2), device="cpu", **kw)
    init = tm.init_params(torch.Generator().manual_seed(7))
    monkeypatch.setattr(JModel, "init", lambda self, key: init)
    got = tmi.structural_warm_start(p_chain, tm)
    _equal_trees(got, jmi.structural_warm_start(p_chain, jm))
    assert all(v.dtype == np.float32 for v in got.values())
    np.testing.assert_array_equal(got["M_re"][:, :1], p_chain["M_re"].astype(np.float32))
    np.testing.assert_array_equal(got["K_re"], (init["K_re"] * 1e-2).astype(np.float32))
    tm.load_numpy_params(got)


def test_load_focus_mpsrnn_equals_jax(tmp_path):
    """A converted FOCUS state dict (bond dimension 3 below dcut 5, the
    boundary M last, ``module.`` prefixes) written with ``torch.save``."""
    rng = np.random.default_rng(3)
    norb, D = 4, 3
    sites = [torch.as_tensor(rng.standard_normal((4, D, D, 2))) for _ in range(norb - 1)]
    sites.append(torch.as_tensor(rng.standard_normal((4, D, 1, 2))))
    sd = {"module.params_M.all_sites": sites,
          "module.params_w.all_sites": torch.as_tensor(rng.standard_normal((norb, D, 2))),
          "module.params_c.all_sites": torch.as_tensor(rng.standard_normal((norb, 2)))}
    path = str(tmp_path / "focus.pth")
    torch.save(sd, path)
    jm, tm, _ = _pair(5, phase_mode="arg", norm_mode="mpsrnn")
    got = tmi.load_focus_mpsrnn(path, tm)
    ref = jmi.load_focus_mpsrnn(path, jm)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    tm.load_numpy_params(got)
    torch.save({"model": sd}, path)  # the {"model": ...} wrapping
    _equal_trees(tmi.load_focus_mpsrnn(path, tm), got)
    dag = GraphMPSRNN(8, 2, 2, dcut=5, graph=grid_snake_graph(2, 2), device="cpu")
    with pytest.raises(ValueError, match="chain graph"):
        tmi.load_focus_mpsrnn(path, dag)


def test_system_from_pth_equals_jax(tmp_path):
    """A molecule file with the keys of ``pynqs_tpu/utils/system.py:
    164-166``: the same integrals, core energy, e_ref, ci_space and
    Slater–Condon tables as the JAX package's reader."""
    rng = np.random.default_rng(4)
    sorb = 8
    h1e = rng.standard_normal((sorb, sorb))
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(sorb)) * 0.1
    ci = torch.as_tensor(rng.integers(0, 255, (6, 1), dtype=np.uint8))
    path = str(tmp_path / "mol.pth")
    torch.save({"h1e": torch.as_tensor(h1e.ravel()), "h2e": torch.as_tensor(h2e), "sorb": sorb,
                "noa": 2, "nob": 2, "ecore": 1.25, "e_lst": [-3.5, -3.25],
                "ci_space": ci}, path)
    ts, js = System.from_pth(path), JSystem.from_pth(path)
    assert (ts.sorb, ts.noa, ts.nob, ts.ecore, ts.e_ref) == (
        js.sorb, js.noa, js.nob, js.ecore, js.e_ref) == (sorb, 2, 2, 1.25, -3.5)
    np.testing.assert_array_equal(ts.h1e, js.h1e)
    np.testing.assert_array_equal(ts.h2e, js.h2e)
    np.testing.assert_array_equal(ts.ci_space, js.ci_space)
    jt, tt = jtables(js.h1e, js.h2e, sorb, np.float64), ts.host_tables
    for k in ("h1e", "h2e", "diag1", "K", "J", "Hpair"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k), err_msg=k)
    torch.save({"h1e": torch.as_tensor(h1e.ravel()), "h2e": torch.as_tensor(h2e),
                "sorb": sorb, "noa": 2, "nob": 2}, path)
    bare = System.from_pth(path)
    assert bare.e_ref is None and bare.ci_space is None and bare.ecore == 0.0


def test_fe2s2_system_names_the_missing_file(monkeypatch, tmp_path):
    monkeypatch.setattr(flagship, "FE2S2_PTH", str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        flagship.fe2s2_system()
    assert os.path.basename(flagship.FE2S2_PTH) == "absent.pth"
