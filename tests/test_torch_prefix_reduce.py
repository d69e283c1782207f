"""REDUCE with ``prefix_fwd`` against the JAX package's REDUCE with its
prefix forward (Pallas in interpret mode), for both deterministic-set
selections; the tolerances of ``tests/test_torch_prefix.py``."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.energy.eloc import local_energy_reduce as jreduce
from pynqs_tpu.ops import fused_rnn_prefix as jpre
from pynqs_tpu.ops.fused_rnn import graph_mpsrnn_logpsi_fused as jfused

from pynqs_tpu_torch.energy.eloc import local_energy_reduce
from pynqs_tpu_torch.ops import fused_rnn_prefix as pre

from test_torch_prefix import BITS, _pair, _systems


@pytest.mark.parametrize("topk", ["exact", "segmax"])
def test_reduce_prefix_matches_jax(topk):
    """k_det = n_sd: no tail, so both are deterministic.  The port's
    REDUCE with its ReducePrefixForward against JAX's REDUCE with its own
    (interpret mode), f32 forwards: 2e-5 (the JAX test's bound)."""
    js, ts = _systems()
    jm, params, tm = _pair(8, 11, phase_mode="arg", norm_mode="mpsrnn")
    rows = BITS[np.random.default_rng(1).integers(0, len(BITS), size=10)]
    n_sd = ts.excitation.n_sd
    jops = tuple(jnp.asarray(np.asarray(x), jnp.float32) for x in js.tables.astuple())
    jpf = jpre.ReducePrefixForward(jm, params, child_block=8, parent_block=8,
                                   matmul_dtype=jnp.float32, interpret=True)
    jflat = partial(jfused, jm, params, interpret=True, matmul_dtype=jnp.float32)
    want = np.asarray(jreduce(
        jflat, jnp.asarray(rows), jops, js.excitation, jax.random.PRNGKey(3), k_det=n_sd,
        n_stoch=8, hpair=jnp.asarray(np.asarray(js.tables.hpair), jnp.float32), topk=topk,
        prefix_fwd=jpf))
    tt = ts.tables("cpu", torch.float32)
    pf = pre.ReducePrefixForward(tm, matmul_dtype=torch.float32)
    got = local_energy_reduce(
        None, torch.as_tensor(rows), tt.astuple(), ts.excitation,
        torch.Generator().manual_seed(3), k_det=n_sd, n_stoch=8, batch=4,
        hpair=tt.hpair_sect, topk=topk, prefix_fwd=pf)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
