"""Port parity, NqsCi updates (the set-up of ``tests/test_torch_nqs_ci.py``):
the parameters after one update against the JAX package's ``_grad_step``
for strategies 0/1/2 (1e-12), the chunked gradient against one chunk,
and the draw that zeroes the CI set."""

import pytest
import torch

from pynqs_tpu_torch.ci.nqs_ci import NqsCi, NqsCiConfig

from test_torch_nqs_ci import STRATEGIES, _common, _jax, _max_param_diff, _port, _port_model


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_grad_step_equals_jax(strategy):
    """One update from the same draw, eigenvector and scale: every
    parameter to 1e-12 (the H_cn backward chunked, the ‖φ'‖ term
    differentiated)."""
    ref = _jax(strategy)
    tm, nc, (bits, w) = _port(strategy)
    eloc, h_nn = nc.eloc_eval(bits, w)
    nc.grad_step(bits, w, eloc, h_nn, ref["c"], 1.7)
    assert _max_param_diff(tm, ref["stepped"]) < 1e-12


def test_chunked_gradient_equals_one_chunk():
    """The chunked H_cn and sampled-row backward against one chunk each
    (1e-12), for the coupled strategy."""
    ref = _jax(1)
    grads = []
    for chunk in (7, None):
        tm, nc, (bits, w) = _port(1)
        nc.cfg.ci_chunk = chunk
        eloc, h_nn = nc.eloc_eval(bits, w)
        grads.append(nc.gradients(bits, w, eloc, h_nn, ref["c"], 0.3))
    assert max(float((a - b).abs().max()) for a, b in zip(*grads)) < 1e-12
    assert max(float(g.abs().max()) for g in grads[0]) > 1e-3


def test_draw_zeroes_the_ci_set():
    """The port's draw: weights sum to 1 outside D and are 0 on D and on
    dead slots."""
    _, nc, _ = _port(1)
    bits, w = nc.draw(torch.Generator().manual_seed(0))
    assert abs(float(w.sum()) - 1.0) < 1e-12
    assert (w[nc._in_d(bits)] == 0).all() and bool((w > 0).any())
    with pytest.raises(ValueError, match="grad_strategy"):
        NqsCi(_port_model(), _common()[0], _common()[4], NqsCiConfig(grad_strategy=3))
