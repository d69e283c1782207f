"""``chip_smoke.py``'s rule for holding a kernel's rows against the plain
version (``hold_rows``), on the CPU.

The rule must fail where a kernel leaves out one of the tensor branch's
bf16 rounding points (U, the product Π, K): here the plain version with
that rounding left out stands in for such a kernel, on the r5g64
flagship's weights (checkpoints/fe2s2_r3_dcut64_r5g64.pkl) on the
seeded stand-in integrals that ``chip_smoke.py`` uses.  It must pass the
same arithmetic summed in f64.  The ill-conditioned branch is also held
to synthetic rows.  Tolerances are ``chip_smoke.py``'s bf16 ones.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils.flagship import flagship_model, load_flagship_params
from pynqs_tpu_torch.utils.system import System

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BF16_TOL = (1e-1, 1e-1)  # (log|ψ|, phase distance)
N_ROWS = 2048


@pytest.fixture(scope="module")
def r5g64():
    """(model, rows, plain bf16 rows, plain bf16 rows with f64 sums)."""
    irng = np.random.default_rng(0)
    h1e = irng.standard_normal((40, 40)) * 0.1
    h1e = (h1e + h1e.T) / 2
    h2e = irng.standard_normal(triangle_size(40)) * 0.01
    system = System.from_integrals(h1e, h2e, 40, 15, 15)
    m = flagship_model(system, 64, use_tensor=True, max_preds=2, device="cpu")
    m.load_numpy_params(load_flagship_params(str(ROOT / "checkpoints" /
                                                 "fe2s2_r3_dcut64_r5g64.pkl")))
    bits = torch.as_tensor(smoke.rand_dets(np.random.default_rng(0), N_ROWS, 40, 15, 15))
    T = fused_rnn.pack_tables(m)
    p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, bits, matmul_dtype=torch.bfloat16,
                                                  tables=T)
    q = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
        m, bits, matmul_dtype=torch.bfloat16, tables={k: v.double() for k, v in T.items()})
    return m, bits, p, q


def test_hold_rows_accepts_the_f64_sums(r5g64):
    _, _, p, q = r5g64
    ok, _, st = smoke.hold_rows(q.float(), p, q, BF16_TOL)
    assert ok, st


_SKIPS = {  # shapes of the tensor branch's operands at dcut 64, dcut_cmpr 4
    "U": lambda x: tuple(x.shape) == (4, 4, 64),
    "K": lambda x: tuple(x.shape) == (4, 64, 4),
    "product": lambda x: x.dim() == 3 and tuple(x.shape[1:]) == (4, 4),
}


@pytest.mark.parametrize("left_out", sorted(_SKIPS))
def test_hold_rows_rejects_a_left_out_rounding_point(r5g64, monkeypatch, left_out):
    m, bits, p, q = r5g64
    skip, rnd = _SKIPS[left_out], fused_rnn._round
    monkeypatch.setattr(fused_rnn, "_round", lambda x, mm: x if skip(x) else rnd(x, mm))
    k = fused_rnn.graph_mpsrnn_logpsi_fused_plain(m, bits, matmul_dtype=torch.bfloat16)
    ok, _, st = smoke.hold_rows(k, p, q, BF16_TOL)
    assert not ok, st
    assert st["med_a"] > 10 * smoke.MED_TOL  # every row moves, not a few


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([rng.normal(-10, 2, n), rng.uniform(-3, 3, n)], -1),
                           dtype=torch.float32)


def _turn(rows, idx, by):
    out = rows.clone()
    out[idx, 1] += by
    return out


def test_hold_rows_ill_conditioned_branch():
    n = 20000
    p = _rows(n, 0)
    q = _turn(p, np.arange(0, n, 100), 1.0).double()  # 1% of the rows far off
    few = _turn(p, np.arange(0, n, 2000), 1.0)  # 10 rows, within 1 in 1000
    many = _turn(p, np.arange(0, n, 500), 1.0)  # 40 rows
    shifted = _turn(p, np.arange(n), 1e-3)  # every row a little
    ok, held, _ = smoke.hold_rows(few, p, q, BF16_TOL)
    assert ok and held == "ill-conditioned"
    assert not smoke.hold_rows(many, p, q, BF16_TOL)[0]
    assert not smoke.hold_rows(shifted, p, q, BF16_TOL)[0]
    assert not smoke.hold_rows(few + torch.tensor([0.2, 0.0]), p, q,
                               BF16_TOL)[0]  # log|ψ| off on every row


def test_hold_rows_well_conditioned_holds_every_row():
    p = _rows(5000, 1)
    q = p.double()
    assert smoke.hold_rows(p.clone(), p, q, BF16_TOL)[:2] == (True, "every row")
    assert not smoke.hold_rows(_turn(p, [7], 0.2), p, q, BF16_TOL)[0]
