"""``fe2s2_nqsci_train.main`` on the CPU at a tiny size, from a CI file and
by capture (the set-up of ``tests/test_torch_nqs_ci.py``)."""

import numpy as np
import pytest
import torch

from pynqs_tpu_torch.ci.solve import save_ci
from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.scripts import fe2s2_nqsci_train
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.checkpoint import load_params, save_params
from pynqs_tpu_torch.utils.flagship import flagship_model
from pynqs_tpu_torch.utils.system import System


@pytest.mark.parametrize("route", ["ci-file", "capture"])
def test_nqsci_train_main_on_the_cpu(route, tmp_path, capsys):
    """The script on a 16-orbital stand-in (the DAG with tensor coupling,
    dcut 4), through ``--ci-file`` and through capture + selected CI: every
    e_tot and |c_m| finite, the parameters changed and saved in the JAX
    format under ``root``."""
    rng = np.random.default_rng(5)
    sorb = 16
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    system = System.from_integrals(h1e, rng.standard_normal(triangle_size(sorb)) * 0.02,
                                   sorb, 2, 2, ecore=1.5)
    m = flagship_model(system, 4, use_tensor=True, max_preds=2, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    ck = str(tmp_path / "s.pkl")
    save_params(ck, dict(m.named_parameters()))
    argv = [ck, "--dcut", "4", "--use-tensor", "--max-preds", "2", "--iters", "2",
            "--n-sample", "20000", "--capacity", "64", "--ci-chunk", "512",
            "--eloc-batch", "16", "--lr", "1e-2", "--tag", "t"]
    if route == "ci-file":
        space = fci.fci_bits(sorb, 2, 2)[::60][:12]
        save_ci(str(tmp_path / "d.npz"), CIWavefunction(np.ones(len(space)), space), e_var=-1.0)
        argv += ["--ci-file", str(tmp_path / "d.npz")]
    else:
        argv += ["--m", "10", "--seed-dets", "4", "--eps1", "1e-3"]
    out = fe2s2_nqsci_train.main(argv, system=system, device="cpu", root=str(tmp_path))
    text = capsys.readouterr().out
    assert "NqsCi 2 iters" in text and "[nqsci] iter" in text
    assert out["m"] == (12 if route == "ci-file" else 10)
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    assert all(np.isfinite(s["c_m"]) and 0.0 < s["ci_mass"] < 1.0 for s in out["stats"])
    saved = load_params(out["path"])
    assert out["path"] == str(tmp_path / "checkpoints" / "fe2s2_r5_t.pkl")
    before = dict(m.named_parameters())
    assert set(saved) == set(before)
    assert any(not np.allclose(saved[k], before[k].detach().numpy()) for k in saved)
