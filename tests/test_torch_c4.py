"""Kernel #1 above dcut 128 on the CPU (the tensor-core kernel's widths
past its register tiers): the plain version against the JAX package's
Pallas kernel, and the host side of the passes.

  * the plain version at dcut 160 (dp 192 in both packages) against
    ``pynqs_tpu.ops.fused_rnn.graph_mpsrnn_logpsi_fused`` in interpret
    mode, f32 matmuls: 1e-5 on log|psi| and 1e-4 on the phase, the
    tolerances of tests/test_torch_fused_mma.py at dcut_cmpr 12;
  * ``pack_mma_tables`` at dp 192 (3 passes of 128 outputs), chain and
    tensor-coupled DAG, in both precisions: the stream read back pass by
    pass as the kernel reads it is the padded W / KW column for column,
    and the f64 emulation of the kernel's walk agrees with the plain
    version (bf16: 1e-9 against f64 sums; f32: 1e-5 / 1e-4);
  * ``mma_launch_shape`` and the global slot file at dp 192 and 256: the
    pass count, the scratch of 8 KB per warp and pass, and every shape
    within the card's shared memory per CTA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynqs_tpu.ops.fused_rnn import graph_mpsrnn_logpsi_fused as jfused
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn
from test_torch_fused_mma import DT, _emulate, _pair, _unpack

f64, f32 = torch.float64, torch.float32


def test_plain_matches_pallas_dcut_160():
    jm, params, tm = _pair(8, 2, 160, 11, phase_mode="arg", norm_mode="mpsrnn")
    bits = fci.fci_bits(8, 2, 2)
    want = np.asarray(jfused(jm, {k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(bits), interpret=True, matmul_dtype=jnp.float32))
    got = fused_rnn.graph_mpsrnn_logpsi_fused(tm, torch.as_tensor(bits),
                                              matmul_dtype=f32).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-5, rtol=0)
    assert np.abs(np.exp(1j * got[:, 1]) - np.exp(1j * want[:, 1])).max() < 1e-4


def _wide(name):
    g = torch.Generator().manual_seed(5)
    if name == "chain":
        return GraphMPSRNN(8, 2, 2, dcut=160, phase_mode="arg", norm_mode="mpsrnn",
                           dtype=f32, device="cpu", generator=g)
    return GraphMPSRNN(12, 3, 3, dcut=140, graph=grid_snake_graph(3, 2), use_tensor=True,
                       dcut_cmpr=6, phase_mode="linear", norm_mode="unit", dtype=f32,
                       device="cpu", generator=g)


@pytest.mark.parametrize("prec", ("bf16", "f32"))
def test_wide_stream_and_emulated_walk(prec):
    for name in ("chain", "tensor-dag"):
        model = _wide(name)
        P = fused_rnn.pack_mma_tables(model, matmul_dtype=DT[prec])
        assert (P["dp"], P["npass"], P["NP"]) == (192, 3, 24)
        T = fused_rnn.pack_tables(model)
        d, dp = model.dcut, P["dp"]
        for t, site in enumerate(_unpack(model, P, prec)):
            npd = len(model.preds[t])
            W = site["W"].reshape(4, npd, 2, dp, 2, dp)
            assert not W[:, :, :, d:].any() and not W[..., d:].any()
            want = T["W"][t].reshape(4, -1, 2, d, 2, d)[:, :npd].to(DT[prec]).double()
            assert torch.equal(W[:, :, :, :d, :, :d], want)
            assert ("KW" in site) == (model.use_tensor and npd >= 2)
        bits = torch.as_tensor(fci.fci_bits(model.sorb, model.noa, model.nob)[:48])
        T = {k: v.double() for k, v in T.items()} if prec == "bf16" else T
        want = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=DT[prec],
                                                         tables=T).double()
        got = _emulate(model, bits, prec)
        ta, tp = {"bf16": (1e-9, 1e-9), "f32": (1e-5, 1e-4)}[prec]
        assert (got[:, 0] - want[:, 0]).abs().max().item() < ta
        dphi = (torch.polar(torch.ones_like(got[:, 1]), got[:, 1])
                - torch.polar(torch.ones_like(want[:, 1]), want[:, 1])).abs().max().item()
        assert dphi < tp


def test_wide_launch_shape():
    """Above dp 128: 4 warps; the slots and the scratch (npass x 16 x 512
    bytes per warp) in shared memory where they fit, else in the global
    file, whose size per row holds them."""
    stages = fused_rnn.STAGES * fused_rnn.STAGE_U4 * 16
    want = {  # (dcut, prec) -> where the slots live
        (160, "bf16"): "shared", (160, "f32"): "global",
        (256, "bf16"): "global", (256, "f32"): "global",
    }
    for (dcut, prec), where in want.items():
        model = GraphMPSRNN(40, 15, 15, dcut=dcut, device="cpu")
        dp = fused_rnn.mma_width(dcut)
        npass = fused_rnn.mma_passes(dp)
        assert npass == dp // 64
        sh = fused_rnn.mma_launch_shape(model, matmul_dtype=DT[prec])
        file = dp // 8 * 512 * (2 if prec == "f32" else 1) + npass * 16 * 512
        assert sh == {"nslots": 1, "slots": where, "warps": 4,
                      "smem_bytes": stages + (4 * file if where == "shared" else 0)}
        assert sh["smem_bytes"] <= fused_rnn.SMEM_LIMIT
        assert (stages + 4 * file <= fused_rnn.SMEM_LIMIT) == (where == "shared")
        for n, n_sm in ((2048, 132), (65536, 132)):
            p = fused_rnn.mma_launch_shape(model, n, n_sm, DT[prec])
            assert p["warps"] <= 4 and p["smem_bytes"] <= fused_rnn.SMEM_LIMIT
        if where == "global":
            N = 100
            _, _, launch, gslots = fused_rnn.mma_operands(model, None, torch.device("cpu"), N,
                                                          sh, DT[prec])
            assert launch[1] == 0
            assert gslots.numel() == -(-N // 64) * 64 * file // 16
    # a DAG's slots and the coupling slot beside the scratch
    dag = GraphMPSRNN(12, 3, 3, dcut=140, graph=grid_snake_graph(3, 2), use_tensor=True,
                      dcut_cmpr=6, device="cpu")
    sh = fused_rnn.mma_launch_shape(dag)
    assert sh["warps"] == 4 and sh["smem_bytes"] <= fused_rnn.SMEM_LIMIT
