"""The fused forward's plain version against the JAX Pallas kernel (interpret
mode, f32 matmuls) past the chain: dcut 40 and 50, a DAG, sites without a
phase readout and the tensor coupling (the cases of
tests/test_fused_rnn.py)."""

import numpy as np
import pytest

from pynqs_tpu.models.graph_mps_rnn import grid_snake_graph as jgrid
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import grid_snake_graph

from test_torch_fused_rnn import _check, _pair


@pytest.mark.parametrize("dcut", [40, 50])
def test_plain_matches_pallas_large_dcut(dcut):
    jm, p, tm = _pair(8, 2, dcut, 7, phase_mode="arg", norm_mode="mpsrnn")
    _check(jm, p, tm, fci.fci_bits(8, 2, 2)[:60])


def test_plain_matches_pallas_dag():
    jm, p, tm = _pair(12, 3, 8, 2, graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2),
                      phase_mode="arg", norm_mode="mpsrnn")
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:100])


def test_plain_matches_pallas_zero_phase_readout_sites():
    """z = 0 must contribute phase 0 (DMRG imports zero all readouts but
    the last)."""
    jm, p, tm = _pair(12, 3, 6, 3, phase_mode="arg", norm_mode="mpsrnn")
    p = dict(p)
    for k in ("w_arg_re", "w_arg_im", "c_arg_re", "c_arg_im"):
        p[k] = p[k].at[:-1].set(0.0)
    tm.load_numpy_params({k: np.asarray(v) for k, v in p.items()})
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:64])


def test_plain_matches_pallas_tensor_coupling():
    jm, p, tm = _pair(12, 3, 8, 4, graph=grid_snake_graph(3, 2), jgraph=jgrid(3, 2),
                      use_tensor=True, dcut_cmpr=4, phase_mode="arg", norm_mode="mpsrnn")
    _check(jm, p, tm, fci.fci_bits(12, 3, 3)[:100])
