"""The prefix-sharing forward's plain version against the JAX package's
(Pallas kernels in interpret mode), both modes, two model families; the
tolerances of ``tests/test_torch_prefix.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.ops import fused_rnn_prefix as jpre

from pynqs_tpu_torch.ops import fused_rnn_prefix as pre

from test_torch_prefix import TOL, _close, _family, _pair


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("modes", [("arg", "mpsrnn"), ("linear", "unit")])
def test_prefix_plain_matches_jax_prefix(modes, mm):
    jm, params, tm = _pair(10, 1, phase_mode=modes[0], norm_mode=modes[1])
    parents, kids = _family(6, 20, 2)
    tmin = jpre.t_min_process_order(jm, jnp.asarray(parents), jnp.asarray(kids))
    assert (np.asarray(tmin) == 0).any() and (np.asarray(tmin) == tm.norb).any()
    jp, jc = jpre.graph_mpsrnn_logpsi_fused_prefix(
        jm, params, jnp.asarray(parents), jnp.asarray(kids), tmin, child_block=8,
        parent_block=8, interpret=True,
        matmul_dtype=jnp.float32 if mm == "f32" else jnp.bfloat16)
    tp, tc = pre.graph_mpsrnn_logpsi_fused_prefix(
        tm, torch.as_tensor(parents), torch.as_tensor(kids),
        torch.as_tensor(np.array(tmin)),
        matmul_dtype=torch.float32 if mm == "f32" else torch.bfloat16)
    assert tp.shape == (6, 2) and tc.shape == (6, 20, 2)
    _close(tp.numpy(), jp, TOL[mm])
    _close(tc.numpy(), jc, TOL[mm])
