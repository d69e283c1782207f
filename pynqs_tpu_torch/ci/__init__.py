"""ci of the PyTorch/CUDA port (see pynqs_tpu/ci)."""

from pynqs_tpu_torch.ci.wavefunction import CIWavefunction  # noqa: F401
from pynqs_tpu_torch.ci.train import CITrain, CITrainConfig  # noqa: F401
from pynqs_tpu_torch.ci.selected import en_pt2, selected_ci  # noqa: F401
from pynqs_tpu_torch.ci.solve import (  # noqa: F401
    cisd_space,
    davidson,
    load_ci,
    save_ci,
    solve_ci,
)
