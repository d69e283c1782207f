"""Port parity: heat-bath selected CI and EN-PT2 (``ci/selected.py``)
against the JAX package, in f64 on the CPU.

The port orders distinct candidates by its int64 row keys and the JAX
package by numpy void keys, so spaces are compared as sets: the same
set, the same sizes per round and the same e_var per round (1e-10), on a
random-integral molecule and on Hubbard; the ``max_space`` cap on a case
without ties at the cut; EN-PT2 to 1e-10; ``fe2s2_hci_precompute.main``
at a cut."""

import jax
import numpy as np
import pytest
import torch

from pynqs_tpu.ci import selected as jsel
from pynqs_tpu.ci import solve as jsolve
from pynqs_tpu.ops import hamiltonian as jham
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.ci import selected
from pynqs_tpu_torch.ci.solve import load_ci
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.scripts import fe2s2_hci_precompute
from pynqs_tpu_torch.utils.system import System


def _systems(kind):
    """(port system, JAX system), f64: Hubbard (5 sites, 2α/2β) or a
    seeded random-integral molecule (sorb 10, 3α/2β)."""
    if kind == "hubbard":
        return System.hubbard_1d(5, 2, 2, u=4.0), JSystem.hubbard_1d(5, 2, 2, u=4.0)
    rng = np.random.default_rng(8)
    sorb = 10
    h1e = rng.standard_normal((sorb, sorb)) * 0.3
    h1e = (h1e + h1e.T) / 2 - np.diag(np.arange(sorb) * 0.2)
    h2e = rng.standard_normal(triangle_size(sorb)) * 0.05
    return (System.from_integrals(h1e, h2e, sorb, 3, 2, ecore=1.1),
            JSystem.from_integrals(h1e, h2e, sorb, 3, 2, ecore=1.1))


def _rows(bits):
    return {tuple(r) for r in np.asarray(bits).tolist()}


@pytest.fixture
def jit_jax_blocks(monkeypatch):
    """The JAX package's ``hij_dense``/``hij_diagonal`` under ``jax.jit``:
    the same functions, compiled once per space size instead of op by op
    (about 3 s per new size on the CPU otherwise)."""
    monkeypatch.setattr(jham, "hij_dense", jax.jit(jham.hij_dense))
    monkeypatch.setattr(jham, "hij_diagonal", jax.jit(jham.hij_diagonal))
    monkeypatch.setattr(jsel, "hij_diagonal", jham.hij_diagonal)


# kind: (eps1, max_rounds, max_space, eps2).  The molecule's second round
# is cut by the cap (55 -> 80 of 100 candidates' worth); Hubbard grows
# freely.
CASES = {"molecule": (2e-3, 2, 80, 0.0), "hubbard": (0.05, 3, 10**6, 1e-3)}


@pytest.mark.parametrize("kind", list(CASES))
def test_selected_ci_and_en_pt2_equal_jax(kind, jit_jax_blocks):
    ts, js = _systems(kind)
    eps1, rounds, cap, eps2 = CASES[kind]
    kw = dict(eps1=eps1, max_rounds=rounds, max_space=cap, eps2=eps2, chunk=16)
    e, ci, info = selected.selected_ci(ts, device="cpu", **kw)
    je, jci, jinfo = jsel.selected_ci(js, **kw)
    assert info["space_sizes"] == jinfo["space_sizes"] and info["rounds"] == jinfo["rounds"]
    assert _rows(ci.bits) == _rows(jci.bits)
    assert len(_rows(ci.bits)) == ci.bits.shape[0]
    np.testing.assert_allclose(info["e_history"], jinfo["e_history"], rtol=0, atol=1e-10)
    assert abs(e - je) < 1e-10
    assert abs(info["e_pt2"] - jinfo["e_pt2"]) < 1e-10
    assert abs(info["e_total"] - jinfo["e_total"]) < 1e-10
    if kind == "molecule":
        assert info["space_sizes"] == [1, 55, 80]
    else:
        assert info["space_sizes"][-1] > 10 and ci.bits.shape[0] < cap


def test_cap_keeps_the_largest_importances_without_ties():
    """The molecule's capped round keeps the candidates of largest
    per-determinant maximum importance, and no importance ties at the
    cut, so the choice does not depend on the candidates' order."""
    ts, _ = _systems("molecule")
    eps1, _, cap, _ = CASES["molecule"]
    _, ci1, _ = selected.selected_ci(ts, eps1=eps1, max_rounds=1, device="cpu")
    tabs = ts.tables("cpu")
    bits1 = torch.as_tensor(ci1.bits)
    cand, imp, _ = selected._screened_connected(
        bits1, torch.as_tensor(ci1.coeffs), tabs.astuple(), tabs.hpair_best, ts.excitation,
        eps1, 16)
    first, imp_max = selected._merge(cand, imp, "amax")
    new = selected._outside(bits1, cand[first])
    ranked, order = torch.sort(imp_max[new], descending=True)
    room = cap - ci1.bits.shape[0]
    assert ranked.shape[0] > room > 0  # the cap cuts this round
    assert ranked[room - 1] > ranked[room] * (1 + 1e-9)  # no tie at the cut
    _, ci2, _ = selected.selected_ci(ts, eps1=eps1, max_rounds=2, max_space=cap, device="cpu")
    assert _rows(ci2.bits) - _rows(ci1.bits) == _rows(cand[first[new]][order[:room]])


def test_en_pt2_called_alone_equals_jax(jit_jax_blocks):
    ts, js = _systems("hubbard")
    e, ci, _ = selected.selected_ci(ts, eps1=0.05, max_rounds=1, device="cpu")
    got = selected.en_pt2(ts, ci, e, eps2=0.0, device="cpu")
    want = jsel.en_pt2(js, ci, e, eps2=0.0)
    assert abs(got - want) < 1e-10, (got, want)


def test_hci_precompute_main_on_the_cpu(tmp_path, capsys):
    """The precompute script at a cut on the molecule: the file under
    ``root`` round-trips through both packages' ``load_ci`` with its
    e_var, and e_var falls in every round."""
    ts, _ = _systems("molecule")
    out = fe2s2_hci_precompute.main(["--eps1", "2e-3", "--max-space", "80", "--max-rounds",
                                     "3", "--chunk", "16"], system=ts, device="cpu",
                                    root=str(tmp_path))
    assert "HCI m=80" in capsys.readouterr().out
    assert out["path"] == str(tmp_path / "checkpoints" / "fe2s2_hci_m80.npz")
    for reader in (load_ci, jsolve.load_ci):
        ci, meta = reader(out["path"])
        assert np.asarray(ci.bits).shape == (80, 10)
        assert float(meta["e_var"]) == out["e_var"] and int(meta["rounds"]) == 2
    h = out["info"]["e_history"]
    assert all(b < a for a, b in zip(h, h[1:])) and h[-1] == out["e_var"]
