"""``fe2s2_gfmc.main`` at a tiny size on the CPU (the system of
``tests/test_torch_gfmc.py``)."""

import numpy as np
import pytest
import torch

from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.scripts import fe2s2_gfmc
from pynqs_tpu_torch.utils.checkpoint import save_params
from pynqs_tpu_torch.utils.system import System


def test_gfmc_script_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The script on a 16-orbital stand-in (the DAG with tensor coupling,
    dcut 4): 32 walkers, 12 iterations, the trial and Green rows on the
    CPU, with and without the dedup."""
    rng = np.random.default_rng(5)
    sorb = 16
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    system = System.from_integrals(h1e, rng.standard_normal(triangle_size(sorb)) * 0.02,
                                   sorb, 2, 2, ecore=1.5)
    from pynqs_tpu_torch.utils.flagship import flagship_model

    m = flagship_model(system, 4, use_tensor=True, max_preds=2, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    save_params(str(tmp_path / "s.pkl"), dict(m.named_parameters()))
    argv = [str(tmp_path / "s.pkl"), "--dcut", "4", "--use-tensor", "--max-preds", "2",
            "--n-walkers", "32", "--n-iter", "12", "--p-steps", "2", "--n-sample", "5000",
            "--init-capacity", "64", "--tail", "6"]
    out = fe2s2_gfmc.main(argv, system=system, device="cpu")
    text = capsys.readouterr().out
    assert "ms/iter" in text and "e_gen[0]" in text and " p= 2 " in text
    assert out["e_gen"].shape == (12,) and np.isfinite(out["e_gen"]).all()
    assert len(out["mixed"]) == 3 and all(np.isfinite(e) for _, e, _ in out["mixed"])
    ded = fe2s2_gfmc.main(argv + ["--dedup-max", "100000"], system=system, device="cpu")
    assert ded["n_unique"].shape == (12,) and (ded["n_unique"] < 32 * 1000).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fe2s2_gfmc.main(argv, system=system)
