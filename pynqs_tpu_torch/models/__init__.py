"""models of the PyTorch/CUDA port (see pynqs_tpu/models)."""

from pynqs_tpu_torch.models.ar_rbm import ARRBM  # noqa: F401
from pynqs_tpu_torch.models.ar_rbm2 import ARRBM2  # noqa: F401
from pynqs_tpu_torch.models.base import Ansatz, ARAnsatz  # noqa: F401
from pynqs_tpu_torch.models.extra import (  # noqa: F401
    DBM,
    HybridWavefunction,
    IsingRBM,
    Jastrow,
    MultiPsi,
    SpinProjected,
)
from pynqs_tpu_torch.models.graph_mps_rnn import (  # noqa: F401
    GraphMPSRNN,
    chain_graph,
    graph_from_edges,
    grid_snake_graph,
)
from pynqs_tpu_torch.models.mps import MPSWavefunction  # noqa: F401
from pynqs_tpu_torch.models.mps_transformer import MPSDecoder  # noqa: F401
from pynqs_tpu_torch.models.rbm import RBM  # noqa: F401
from pynqs_tpu_torch.models.rnn import RNNWavefunction  # noqa: F401
from pynqs_tpu_torch.models.transformer import DecoderWavefunction  # noqa: F401
