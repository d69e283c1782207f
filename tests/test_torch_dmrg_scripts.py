"""The DMRG warm-start scripts and the Fe2S2 example through their
``main``s on the CPU, at a tiny size on seeded stand-in integrals and
test-written converted FOCUS files: the command lines are the JAX
scripts' (every JAX option with its type, default and action; the port
adds ``--dcut``/``--focus`` to the two DMRG scripts, whose files the JAX
scripts hard-code), ``fe2s2_train_from_dmrg`` runs its AdamW/REDUCE
steps from the warm start (the first step's energy is the imported
state's), ``validate_fe2s2_import``'s REDUCE equals SIMPLE where k_det
covers every connection, and the example builds the JAX package's
Fiedler-ordered DAG."""

import pathlib

import numpy as np
import pytest
import torch

from pynqs_tpu.utils.graph import dag_from_order as jdag
from pynqs_tpu.utils.graph import exchange_matrix as jexchange
from pynqs_tpu.utils.graph import fiedler_order as jfiedler

from pynqs_tpu_torch.examples import fe2s2_graph_mps_rnn
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.scripts import (
    fe2s2_train_from_dmrg,
    kdet_rebalance_check,
    spin_subspace_eval,
    validate_fe2s2_import,
)
from pynqs_tpu_torch.utils import focus_ctns
from pynqs_tpu_torch.utils.system import System
from test_torch_focus_ctns import random_ctns
from test_torch_train import _jax_script_flags

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stand_in(sorb=12, n=3, seed=0):
    rng = np.random.default_rng(seed)
    h1 = rng.standard_normal((sorb, sorb)) * 0.2
    h1 = (h1 + h1.T) / 2
    return System.from_integrals(h1, rng.standard_normal(triangle_size(sorb)) * 0.05, sorb, n, n,
                                 2.0)


def write_focus(path, norb, bond, seed):
    """A converted FOCUS file (the torch state dict load_focus_mpsrnn reads)."""
    sd = focus_ctns.ctns_state_dict(random_ctns(norb, bond, seed)[0])
    torch.save({"params_M.all_sites": [torch.as_tensor(m) for m in sd["params_M.all_sites"]],
                "params_w.all_sites": torch.as_tensor(sd["params_w.all_sites"]),
                "params_c.all_sites": torch.as_tensor(sd["params_c.all_sites"])}, path)
    return str(path)


def _port_flags(ap):
    got = {}
    for a in ap._actions:
        if not a.option_strings or a.dest == "help":
            continue
        kw = {"default": a.default}
        if a.type is not None:
            kw["type"] = a.type.__name__
        if a.const is True:
            kw = {"action": "store_true"}
        got[a.option_strings[0]] = kw
    return got


def test_flags_equal_the_jax_scripts():
    for mod, src, extra in (
        (fe2s2_train_from_dmrg, "scripts/fe2s2_train_from_dmrg.py", {"--dcut", "--focus"}),
        (validate_fe2s2_import, "scripts/validate_fe2s2_import.py", {"--dcut", "--focus"}),
        (fe2s2_graph_mps_rnn, "examples/fe2s2_graph_mps_rnn.py", set()),
        (spin_subspace_eval, "scripts/spin_subspace_eval.py", set()),
        (kdet_rebalance_check, "scripts/kdet_rebalance_check.py", set()),
    ):
        # options only (spin_subspace_eval's checkpoint is positional in
        # both); the example's --pth default is the flagship integrals' path
        want = {k: v for k, v in _jax_script_flags(ROOT / src).items()
                if k.startswith("--") and k != "--pth"}
        got = _port_flags(mod.parser())
        got.pop("--pth", None)
        assert set(got) - set(want) == extra, src
        assert {k: got[k] for k in want} == want, src
    assert fe2s2_graph_mps_rnn.parser().parse_args([]).pth.endswith("fe2s2-OO.pth")


def test_train_from_dmrg_main(tmp_path, capsys):
    system = stand_in()
    focus = write_focus(tmp_path / "focus.pth", 6, 6, 4)
    out = fe2s2_train_from_dmrg.main(
        ["--iters", "3", "--n-sample", "4000", "--capacity", "64", "--dcut", "8",
         "--focus", focus], system=system, device="cpu", root=str(tmp_path))
    hist = out["history"]
    assert len(hist) == 3 and np.isfinite(hist).all()
    vmc = out["vmc"]
    assert vmc.cfg.eloc_method == "reduce" and (vmc.cfg.eloc_k_det, vmc.cfg.eloc_n_stoch,
                                                vmc.cfg.eloc_batch) == (512, 128, 256)
    assert vmc.cfg.clip_grad == 0.1 and vmc.cfg.optimizer == "adamw" and vmc.cfg.lr == 2e-4
    assert vmc.model.dcut == 8 and vmc.model.M_re.dtype == torch.float64
    assert "3 iterations in" in capsys.readouterr().out


def test_validate_import_main(tmp_path, monkeypatch):
    """With k_det (1024) above the 117 connections of sorb 12, 3α/3β the
    REDUCE energy is SIMPLE's: the tail is empty."""
    system = stand_in()
    focus = write_focus(tmp_path / "focus.pth", 6, 6, 5)
    monkeypatch.setattr(validate_fe2s2_import, "N_SAMPLE", 20000)
    monkeypatch.setattr(validate_fe2s2_import, "CAPACITY", 512)
    out = validate_fe2s2_import.main(["--dcut", "8", "--focus", focus], system=system,
                                     device="cpu")
    assert np.isfinite(out["e_reduce"]) and out["kept"] == 20000
    assert abs(out["e_reduce"] - out["e_simple"]) < 1e-10


def test_example_main_builds_the_jax_graph():
    system = stand_in(sorb=16, n=3, seed=1)
    out = fe2s2_graph_mps_rnn.main(["--iters", "2", "--n-sample", "2000", "--capacity", "64",
                                    "--dcut", "6"], system=system, device="cpu")
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    K = jexchange(system.h2e, system.sorb)
    order, preds = jdag(jfiedler(K), K, max_preds=2)
    assert [int(s) for s in out["graph"][0]] == [int(s) for s in order]
    assert [[int(p) for p in ps] for ps in out["graph"][1]] == [[int(p) for p in ps]
                                                               for ps in preds]
    model = out["vmc"].model
    assert model.maxp == 2 and model.dcut == 6 and model.M_re.dtype == torch.float64
