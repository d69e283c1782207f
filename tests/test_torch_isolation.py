"""The port stands alone: no JAX, nothing of the JAX package, and no
quiet continuation on the CPU when a card was asked for."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "pynqs_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
GPU_TESTS = ROOT / "tests" / "test_torch_gpu.py"  # run where only torch is installed


def _sources():
    return sorted(PORT.rglob("*.py")) + [SMOKE, GPU_TESTS]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "pynqs_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pynqs_tpu_torch\n"
        "for m in pkgutil.walk_packages(pynqs_tpu_torch.__path__, 'pynqs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pynqs_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('pynqs_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15  # every module of the port was imported


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.ops.fused_rnn_prefix import ReducePrefixForward
    from pynqs_tpu_torch.utils.checkpoint import params_from_numpy
    from pynqs_tpu_torch.utils.flagship import flagship_model
    from pynqs_tpu_torch.utils.system import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphMPSRNN(8, 2, 2, dcut=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System.hubbard_1d(4, 2, 2).tables()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"a": np.zeros(2)})
    system = System.hubbard_1d(4, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship_model(system, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship_model(system, 4, use_tensor=True, max_preds=2)
    # asked for explicitly, the CPU works, and the prefix forward follows
    # its model's device
    assert GraphMPSRNN(8, 2, 2, dcut=4, device="cpu").M_re.device.type == "cpu"
    pf = ReducePrefixForward(flagship_model(system, 4, device="cpu"))
    assert pf.tables["W"].device.type == "cpu"


def test_evaluation_entry_points_raise_without_a_card(monkeypatch):
    """ExactSampler's space, the device tables with the dense pair matrix
    and the final-state evaluation default to the card; asked for the
    CPU, they run there."""
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.sampler.exact import ExactSampler
    from pynqs_tpu_torch.scripts.eval_fe2s2_final import evaluate
    from pynqs_tpu_torch.utils.system import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = System.hubbard_1d(4, 2, 2)
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu")
    kw = dict(n_sample=1000, capacity=36, n_group=1, split_depth=2, k_det=0, n_rep=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExactSampler(8, 2, 2).space()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        system.tables()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(model, system, **kw)
    assert ExactSampler(8, 2, 2).space("cpu").shape == (36, 8)
    t = system.tables("cpu")
    assert t.hpair.shape == (28, 28) and t.hpair.device.type == "cpu"
    (rep,) = evaluate(model, system, device="cpu", **kw)
    assert np.isfinite(rep.e) and rep.n_live > 0 and rep.rows.device.type == "cpu"


def test_refinement_entry_points_raise_without_a_card(monkeypatch):
    """GFMC, its CI trial and the CI-NQS polish default to the card; asked
    for the CPU, they run there."""
    from pynqs_tpu_torch.ci.nqs_ci import ci_polish
    from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
    from pynqs_tpu_torch.gfmc.walker import GFMC, ci_trial_log_psi
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.utils.fci import fci_bits
    from pynqs_tpu_torch.utils.system import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = System.hubbard_1d(4, 2, 2)
    space = fci_bits(8, 2, 2)
    ci = CIWavefunction(coeffs=np.ones(len(space)), bits=space)
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ci_trial_log_psi(ci)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GFMC(model.log_psi, system)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ci_polish(model, system, space[:4], space, torch.Generator())
    trial = ci_trial_log_psi(ci, device="cpu")
    out = GFMC(trial, system, device="cpu").run(space[:16], n_iter=2)
    assert np.isfinite(out["e_gen"]).all()
    e, _, _ = ci_polish(model, system, space[:4], space, torch.Generator(), device="cpu",
                        k_det=system.excitation.n_sd)
    assert np.isfinite(e)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """No card (hidden from the process) or no repository beside the
    script: a non-zero exit and no result line."""
    if where == "alone":
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_ci_ladder_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """Selected CI, EN-PT2, both CI-ladder scripts and NqsCi's model default
    to the card; asked for the CPU, they run there."""
    from pynqs_tpu_torch.ci.nqs_ci import NqsCi, NqsCiConfig
    from pynqs_tpu_torch.ci.selected import en_pt2, selected_ci
    from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
    from pynqs_tpu_torch.scripts import fe2s2_hci_precompute, fe2s2_nqsci_train
    from pynqs_tpu_torch.utils.flagship import flagship_model
    from pynqs_tpu_torch.utils.system import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = System.hubbard_1d(4, 2, 2)
    ci = CIWavefunction.hf_rooted(8, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selected_ci(system)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        en_pt2(system, ci, -1.0)
    for script in (fe2s2_hci_precompute, fe2s2_nqsci_train):
        argv = [] if script is fe2s2_hci_precompute else ["unused.pkl"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(argv, system=system, root=str(tmp_path))
    e, ci2, _ = selected_ci(system, eps1=1e-3, max_rounds=2, device="cpu")
    assert np.isfinite(e) and ci2.bits.shape[0] > 1
    assert np.isfinite(en_pt2(system, ci2, e, device="cpu"))
    model = flagship_model(system, 4, device="cpu")
    nq = NqsCi(model, system, ci2.bits[:4], NqsCiConfig(n_sample=1000, capacity=36,
                                                         log_every=0))
    c, hist = nq.run(torch.Generator().manual_seed(0), n_iter=1)
    assert np.isfinite(hist).all() and c.shape == (5,)
    assert nq._h_cc.device.type == "cpu"


def test_sr_trainer_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """fe2s2_r2_push's main and the feature tour default to the card; a
    VMC with CG-SR runs where its model lives, asked for the CPU, and its
    SR update stays there."""
    from pynqs_tpu_torch.examples import feature_tour
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
    from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
    from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
    from pynqs_tpu_torch.scripts import fe2s2_r2_push
    from pynqs_tpu_torch.utils.fci import fci_bits
    from pynqs_tpu_torch.utils.system import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = System.hubbard_1d(4, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fe2s2_r2_push.main(["--stage", "64", "--sr"], system=system, root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feature_tour.main()
    assert not (tmp_path / "logs").exists()
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu")
    v = VMC(model, system, RestrictedSampler(8, 2, 2, states=fci_bits(8, 2, 2)),
            VMCConfig(optimizer="sgd", use_sr=True, sr_solver="cg", sr_n_cg=3))
    bits, w, _ = v.sampler.sample(model)
    grads = v.sr_gradient(bits, w, v.local_energy(bits, torch.Generator()))
    assert all(g.device.type == "cpu" and torch.isfinite(g).all() for g in grads.values())
    assert np.isfinite(float(v.step(torch.Generator(), 1.0)["energy"]))
