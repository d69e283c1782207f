"""Card-only tests of the port: the fused forward's CUDA kernel (the
tensor-core kernel in bf16 and in f32 as three TF32 products; tensor
coupling included, at dcut_cmpr 4 and 12), the prefix-sharing kernels (on
the tensor cores in both precisions, bit for bit the flat tensor-core
kernel's rows in the same precision) and the doubles pair selection
against their plain versions, and VMC steps (with the REDUCE forward
dedup too, and with CG-SR) and the dense ``comb_hij`` that go through the
kernels; the SR solvers against each other in f64 and ``safe_atan2``'s
forward mode on the card; the dp-128 forward under ``hold_rows``; the
forward and the prefix passes above dp 128 (in passes of 128 outputs); the
data-parallel step over one NCCL rank (bit for bit the step without a
mesh) and two gloo ranks on one card, and ``entry()``.

They import neither JAX nor the JAX package, so they also run where only
PyTorch for CUDA is installed.  On a machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX for the
other test files.)  Without a card every test here skips.
"""

import importlib.util
import itertools
import math
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.ops import fused_rnn_prefix as pre
from pynqs_tpu_torch.ops import pair_select as ps
from pynqs_tpu_torch.ops.hamiltonian import comb_hij
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.checkpoint import load_params
from pynqs_tpu_torch.utils.flagship import flagship_graph, flagship_model
from pynqs_tpu_torch.utils.system import System

pytestmark = pytest.mark.gpu

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "fe2s2_dcut48_final.pkl")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _all_dets(sorb, noa, nob):
    norb = sorb // 2
    rows = []
    for a in itertools.combinations(range(norb), noa):
        for b in itertools.combinations(range(norb), nob):
            r = np.zeros(sorb, np.int8)
            r[[2 * i for i in a]] = 1
            r[[2 * i + 1 for i in b]] = 1
            rows.append(r)
    return np.stack(rows)


def _rand_dets(n, sorb, noa, nob, seed):
    rng = np.random.default_rng(seed)
    norb = sorb // 2
    out = np.zeros((n, sorb), np.int8)
    for s, no in ((0, noa), (1, nob)):
        cols = np.argsort(rng.random((n, norb)), axis=1)[:, :no]
        out[np.repeat(np.arange(n), no), 2 * cols.ravel() + s] = 1
    return out


def _model(case, dev):
    g = torch.Generator().manual_seed(0)
    if case == "fe2s2-dcut48":
        m = GraphMPSRNN(40, 15, 15, dcut=48, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device=dev)
        return m.load_numpy_params(load_params(CKPT)), _rand_dets(4096, 40, 15, 15, 0)
    graph, phase, norm, dcut = {
        "chain-arg-mpsrnn-d10": (None, "arg", "mpsrnn", 10),
        "dag-arg-mpsrnn-d10": (grid_snake_graph(3, 2), "arg", "mpsrnn", 10),
        "chain-linear-unit-d24": (None, "linear", "unit", 24),
        "dag-linear-unit-d100": (grid_snake_graph(3, 2), "linear", "unit", 100),
        "dag-tensor-arg-mpsrnn-d10": (grid_snake_graph(3, 2), "arg", "mpsrnn", 10),
        "dag-tensor-linear-unit-d64": (grid_snake_graph(3, 2), "linear", "unit", 64),
    }[case]
    m = GraphMPSRNN(12, 3, 3, dcut=dcut, graph=graph, phase_mode=phase, norm_mode=norm,
                    use_tensor="tensor" in case, dcut_cmpr=4,
                    dtype=torch.float32, device=dev, generator=g)
    return m, _all_dets(12, 3, 3)


def _agree(k, p, mm):
    assert k.shape == p.shape and torch.isfinite(k).all()
    ta, tp = (1e-4, 1e-3) if mm == "f32" else (1e-1, 1e-1)
    assert (k[:, 0] - p[:, 0]).abs().max().item() < ta
    d = (torch.polar(torch.ones_like(k[:, 1]), k[:, 1])
         - torch.polar(torch.ones_like(p[:, 1]), p[:, 1])).abs().max().item()
    assert d < tp


def _mode_counts():
    return fused_rnn.LAUNCHES.n, fused_rnn.MMA_LAUNCHES.n, fused_rnn.F32_MMA_LAUNCHES.n


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["chain-arg-mpsrnn-d10", "dag-arg-mpsrnn-d10",
                                  "chain-linear-unit-d24", "dag-linear-unit-d100",
                                  "fe2s2-dcut48", "dag-tensor-arg-mpsrnn-d10",
                                  "dag-tensor-linear-unit-d64"])
def test_cuda_kernel_matches_plain(case, mm, dev):
    """One launch per call, of the tensor-core kernel in its mode (bf16,
    or f32 as three TF32 products: ``F32_MMA_LAUNCHES`` up, ``MMA_LAUNCHES``
    unmoved), and the plain version's values: 1e-4 on log|ψ| and 1e-3 on
    the unit-circle phase in f32 (the sums differ in order, and the TF32
    split leaves out about 2^-22 of each product); 1e-1 in bf16, where an
    f32 difference of one ulp can move h across a bf16 rounding boundary
    and the steps compound."""
    model, dets = _model(case, dev)
    bits = torch.as_tensor(dets, device=dev)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    before = _mode_counts()
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=dt)
    torch.cuda.synchronize()
    assert _mode_counts() == (before[0] + 1, before[1] + (mm == "bf16"),
                              before[2] + (mm == "f32"))
    p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=dt)
    assert k.shape == (bits.shape[0], 2)
    _agree(k, p, mm)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("rows", ["0", "5", "tile+1"])
@pytest.mark.parametrize("case", ["fe2s2-dcut48", "dag-tensor-linear-unit-d64"])
def test_mma_kernel_ragged_rows(case, rows, mm, dev):
    """N = 0 (no launch), 5 rows (less than a warp's 16) and one CTA's
    rows + 1, in either mode: rows past N are neither written nor felt
    by the others."""
    model, dets = _model(case, dev)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    tile = 16 * fused_rnn.mma_launch_shape(model, matmul_dtype=dt)["warps"]
    n = {"0": 0, "5": 5, "tile+1": tile + 1}[rows]
    bits = torch.as_tensor(np.resize(dets, (max(n, 1), dets.shape[1]))[:n], device=dev)
    counter = fused_rnn.MMA_LAUNCHES if mm == "bf16" else fused_rnn.F32_MMA_LAUNCHES
    before = counter.n
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=dt)
    torch.cuda.synchronize()
    assert counter.n == before + (n > 0)
    p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=dt)
    assert k.shape == (n, 2)
    if n:
        _agree(k, p, mm)
        # the same rows inside a full batch give the same values
        full = fused_rnn.graph_mpsrnn_logpsi_fused(
            model, torch.cat([bits, bits.flip(0)]), matmul_dtype=dt)
        assert torch.equal(full[:n], k)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_mma_kernel_dcut_cmpr_12_r5g64_graph(mm, dev):
    """A tensor-coupled model past dcut_cmpr 8 (12, padded to 16: two
    blocks of 8 c's, the coupling slot 2 or 4 k-steps per value) on the
    r5g64 stand-in graph at dcut 64: one launch of the tensor-core kernel
    in its mode, held to the plain version by ``chip_smoke.hold_rows``
    (the f64-sum plain version beside it for ill-conditioned phases)."""
    rng = np.random.default_rng(0)
    h1e = rng.standard_normal((40, 40)) * 0.1
    system = System.from_integrals((h1e + h1e.T) / 2,
                                   rng.standard_normal(triangle_size(40)) * 0.01, 40, 15, 15)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    model = GraphMPSRNN(40, 15, 15, dcut=64, graph=flagship_graph(system, 2), phase_mode="arg",
                        norm_mode="mpsrnn", use_tensor=True, dcut_cmpr=12, device=dev,
                        generator=torch.Generator().manual_seed(0))
    assert fused_rnn.pack_mma_tables(model, matmul_dtype=dt)["dcp"] == 16
    bits = torch.as_tensor(_rand_dets(4096, 40, 15, 15, 6), device=dev)
    before = _mode_counts()
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=dt)
    torch.cuda.synchronize()
    assert _mode_counts() == (before[0] + 1, before[1] + (mm == "bf16"),
                              before[2] + (mm == "f32"))
    T = fused_rnn.pack_tables(model)
    p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=dt, tables=T)
    q = fused_rnn.graph_mpsrnn_logpsi_fused_plain(
        model, bits, matmul_dtype=dt, tables={key: v.double() for key, v in T.items()})
    tol = {"f32": (1e-4, 1e-3), "bf16": (1e-1, 1e-1)}[mm]
    ok, _, st = smoke.hold_rows(k, p, q, tol)
    assert ok, st


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_mma_kernel_global_hidden_slots(mm, dev):
    """The r5g64 stand-in graph (7 live hiddens) where the slots do not fit
    in shared memory, at dcut 128 in bf16 and at its own dcut 64 in f32
    (twice the bytes per slot): they go to the file in global memory; the
    plain version's values all the same."""
    rng = np.random.default_rng(0)
    h1e = rng.standard_normal((40, 40)) * 0.1
    system = System.from_integrals((h1e + h1e.T) / 2,
                                   rng.standard_normal(triangle_size(40)) * 0.01, 40, 15, 15)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    model = flagship_model(system, {"f32": 64, "bf16": 128}[mm], use_tensor=True, max_preds=2,
                           device=dev, generator=torch.Generator().manual_seed(0))
    shape = fused_rnn.mma_launch_shape(model, matmul_dtype=dt)
    assert shape["slots"] == "global" and shape["nslots"] == 7, shape
    bits = torch.as_tensor(_rand_dets(1000, 40, 15, 15, 5), device=dev)
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=dt)
    p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=dt)
    _agree(k, p, mm)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["chain-d160", "chain-d256", "dag-tensor-d140"])
def test_mma_kernel_above_dp_128(case, mm, dev):
    """Kernel #1 above dp 128 (dp / 64 passes of 128 outputs; ROADMAP C4):
    chains at dcut 160 (dp 192, slots in shared memory in bf16) and 256
    (dp 256, the global file), a tensor-coupled DAG at dcut 140, one launch
    in its mode, the plain version's values; ragged rows (a partial CTA)."""
    g = torch.Generator().manual_seed(3)
    if case == "dag-tensor-d140":
        model = GraphMPSRNN(40, 15, 15, dcut=140, graph=grid_snake_graph(4, 5), use_tensor=True,
                            dcut_cmpr=6, phase_mode="linear", norm_mode="unit", device=dev,
                            generator=g)
    else:
        model = GraphMPSRNN(40, 15, 15, dcut=int(case[7:]), phase_mode="arg",
                            norm_mode="mpsrnn", device=dev, generator=g)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    assert fused_rnn.mma_passes(fused_rnn.mma_width(model.dcut)) > 1
    bits = torch.as_tensor(_rand_dets(1000, 40, 15, 15, 7), device=dev)
    counter = fused_rnn.F32_MMA_LAUNCHES if mm == "f32" else fused_rnn.MMA_LAUNCHES
    n0 = counter.n
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=dt)
    torch.cuda.synchronize()
    assert counter.n == n0 + 1
    _agree(k, fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, bits, matmul_dtype=dt), mm)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_mma_prefix_above_dp_128(mm, dev):
    """The prefix passes of a dcut-160 chain (dp 192, 3 passes): the
    plain version's values, and bit for bit the flat kernel's rows."""
    model = GraphMPSRNN(40, 15, 15, dcut=160, phase_mode="arg", norm_mode="mpsrnn", device=dev,
                        generator=torch.Generator().manual_seed(4))
    par = _rand_dets(40, 40, 15, 15, 8)
    parents = torch.as_tensor(par, device=dev)
    kids = torch.as_tensor(_excitations(par, 12, 9), device=dev)
    _hold_prefix(model, parents, kids, pre.t_min_process_order(model, parents, kids), mm)


def _never_plain_or_cuda_cores(dev, monkeypatch, dt):
    def boom(*a, **k):
        raise AssertionError("the plain version or the CUDA-core kernel ran on CUDA rows")

    monkeypatch.setattr(fused_rnn, "graph_mpsrnn_logpsi_fused_plain", boom)
    monkeypatch.setattr(fused_rnn, "_launch_simt", boom)
    monkeypatch.setattr(fused_rnn, "_launch_f32_cuda_cores", boom)
    monkeypatch.setattr(fused_rnn, "_launch_cuda_cores", boom)
    for case in ("fe2s2-dcut48", "dag-tensor-arg-mpsrnn-d10"):
        model, dets = _model(case, dev)
        fused_rnn.graph_mpsrnn_logpsi_fused(model, torch.as_tensor(dets, device=dev),
                                            matmul_dtype=dt)
    torch.cuda.synchronize()


def test_bf16_rows_on_card_never_take_the_plain_version_or_the_cuda_cores(dev, monkeypatch):
    _never_plain_or_cuda_cores(dev, monkeypatch, torch.bfloat16)


def test_f32_rows_on_card_never_take_the_plain_version_or_the_cuda_cores(dev, monkeypatch):
    _never_plain_or_cuda_cores(dev, monkeypatch, torch.float32)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_tables_off_the_card_or_not_contiguous_raise(mm, dev):
    """The wrapper takes contiguous f32 tables on the rows' device only."""
    model, dets = _model("dag-tensor-arg-mpsrnn-d10", dev)
    bits = torch.as_tensor(dets, device=dev)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    T = fused_rnn.pack_tables(model)
    before = _mode_counts()
    with pytest.raises(ValueError, match="contiguous f32"):
        fused_rnn.graph_mpsrnn_logpsi_fused(
            model, bits, matmul_dtype=dt, tables={k: v.cpu() for k, v in T.items()})
    with pytest.raises(ValueError, match="contiguous f32"):
        fused_rnn.graph_mpsrnn_logpsi_fused(
            model, bits, matmul_dtype=dt, tables={**T, "W": T["W"].transpose(-1, -2)})
    assert _mode_counts() == before


def _close(a, b, tol):
    da = (a[..., 0] - b[..., 0]).abs().max().item()
    dp = (torch.polar(torch.ones_like(a[..., 1]), a[..., 1])
          - torch.polar(torch.ones_like(b[..., 1]), b[..., 1])).abs().max().item()
    assert da < tol[0] and dp < tol[1], (da, dp)


def _excitations(parents, C, seed):
    """C children per parent: singles and doubles that keep each spin's
    electron count, child 0 equal to its parent, child 1 a random
    determinant (first changed site usually 0)."""
    rng = np.random.default_rng(seed)
    B, sorb = parents.shape
    kids = np.repeat(parents[:, None, :], C, axis=1)
    for b in range(B):
        for c in range(2, C):
            for _ in range(rng.integers(1, 3)):
                s = rng.integers(0, 2)
                occ = np.flatnonzero(kids[b, c, s::2]) * 2 + s
                vir = np.flatnonzero(1 - kids[b, c, s::2]) * 2 + s
                kids[b, c, rng.choice(occ)] = 0
                kids[b, c, rng.choice(vir)] = 1
    kids[:, 1] = _rand_dets(B, sorb, int(parents[0, 0::2].sum()), int(parents[0, 1::2].sum()),
                            seed + 1)
    return kids


def _prefix_counts():
    return (pre.PARENT_LAUNCHES.n, pre.CHILD_LAUNCHES.n, pre.MMA_PARENT_LAUNCHES.n,
            pre.MMA_CHILD_LAUNCHES.n, fused_rnn.LAUNCHES.n)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_cuda_prefix_kernels_match_plain_and_flat(mm, dev):
    """One parent and one child launch per call, on the tensor cores in
    either precision; the values of the plain version at the tolerances
    above, and bit for bit the flat tensor-core kernel's in the same
    precision on the same rows."""
    model, _ = _model("fe2s2-dcut48", dev)
    parents = torch.as_tensor(_rand_dets(96, 40, 15, 15, 3), device=dev)
    kids = torch.as_tensor(_excitations(parents.cpu().numpy(), 50, 4), device=dev)
    t_min = pre.t_min_process_order(model, parents, kids)
    assert (t_min == 0).any() and (t_min == 20).any()
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    tol = (1e-4, 1e-3) if mm == "f32" else (1e-1, 1e-1)
    before = _prefix_counts()
    kp, kc = pre.graph_mpsrnn_logpsi_fused_prefix(model, parents, kids, t_min, matmul_dtype=dt)
    torch.cuda.synchronize()
    assert _prefix_counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1,
                                before[4])
    pp, pc = pre.graph_mpsrnn_logpsi_fused_prefix_plain(model, parents, kids, t_min,
                                                        matmul_dtype=dt)
    assert torch.isfinite(kp).all() and torch.isfinite(kc).all()
    _close(kp, pp, tol)
    _close(kc, pc, tol)
    flat = fused_rnn.graph_mpsrnn_logpsi_fused(
        model, torch.cat([parents, kids.reshape(-1, 40).to(parents.dtype)]), matmul_dtype=dt)
    assert torch.equal(kp, flat[:96])
    assert torch.equal(kc.reshape(-1, 2), flat[96:])


def _prefix_rows(dev, n_par, C, s0, seed=5):
    """The dcut-48 chain, n_par parents with C children each and their
    t_min: "mixed" (excitations; 0, norb and between, across parents),
    "zero" (every child from site 0) or "norb" (children equal to their
    parents)."""
    model, _ = _model("fe2s2-dcut48", dev)
    par = _rand_dets(n_par, 40, 15, 15, seed)
    if s0 == "norb" or n_par == 0:
        kids = np.repeat(par[:, None], C, axis=1)
    else:  # past child 0 (the parent) and child 1 (a random determinant) when C < 3
        kids = _excitations(par, C + 2, seed + 1)[:, -C:] if C < 3 else _excitations(
            par, C, seed + 1)
    parents, kids = torch.as_tensor(par, device=dev), torch.as_tensor(kids, device=dev)
    t_min = pre.t_min_process_order(model, parents, kids)
    if s0 == "zero":
        t_min = torch.zeros_like(t_min)
    return model, parents, kids, t_min


def _hold_prefix(model, parents, kids, t_min, mm="bf16"):
    """The tensor-core passes in ``mm``: one launch each (none for no
    rows), the plain version's values at the tolerance of ``mm``, and the
    flat tensor-core kernel's in ``mm`` bit for bit."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[mm]
    before = _prefix_counts()
    kp, kc = pre.graph_mpsrnn_logpsi_fused_prefix(model, parents, kids, t_min, matmul_dtype=dt)
    torch.cuda.synchronize()
    lp, lc = int(parents.shape[0] > 0), int(kids.shape[0] * kids.shape[1] > 0)
    assert _prefix_counts() == (before[0] + lp, before[1] + lc, before[2] + lp,
                                before[3] + lc, before[4])
    rows = torch.cat([parents, kids.reshape(-1, 40)])
    if rows.shape[0] == 0:
        assert kp.shape == (0, 2) and kc.numel() == 0
        return
    pp, pc = pre.graph_mpsrnn_logpsi_fused_prefix_plain(model, parents, kids, t_min,
                                                        matmul_dtype=dt)
    _close(torch.cat([kp, kc.reshape(-1, 2)]), torch.cat([pp, pc.reshape(-1, 2)]),
           (1e-4, 1e-3) if mm == "f32" else (1e-1, 1e-1))
    flat = fused_rnn.graph_mpsrnn_logpsi_fused(model, rows, matmul_dtype=dt)
    assert torch.equal(kp, flat[:parents.shape[0]])
    assert torch.equal(kc.reshape(-1, 2), flat[parents.shape[0]:])


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("s0", ["mixed", "zero", "norb"])
def test_mma_prefix_first_changed_sites(s0, mm, dev):
    """Child tiles that start at 0, at norb (no site runs: the parent's
    state) and in between, across parents; rows shuffled so that the
    wrapper's sort matters."""
    model, parents, kids, t_min = _prefix_rows(dev, 64, 40, s0)
    norb = model.norb
    assert {"mixed": bool((t_min == 0).any() and (t_min == norb).any()
                          and ((t_min > 0) & (t_min < norb)).any()),
            "zero": bool((t_min == 0).all()), "norb": bool((t_min == norb).all())}[s0]
    perm = torch.randperm(kids.shape[1], generator=torch.Generator().manual_seed(0))
    _hold_prefix(model, parents, kids[:, perm], t_min[:, perm], mm)


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("rows", ["0", "5", "tile+1", "grid+1"])
def test_mma_prefix_ragged_rows(rows, mm, dev):
    """Parent and child passes at N = 0, 5, one CTA of the small-N shape
    (1 warp) + 1, and one row past a grid of 8-warp CTAs that fills the
    SMs: rows past N are neither written nor felt by the others."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    model, _ = _model("fe2s2-dcut48", dev)
    n = {"0": 0, "5": 5, "tile+1": 17, "grid+1": n_sm * 128 + 1}[rows]
    shape = fused_rnn.mma_launch_shape(model, n, n_sm,
                                       torch.float32 if mm == "f32" else torch.bfloat16)
    if rows == "tile+1":
        assert shape["warps"] == 1 and shape["ctas"] == 2
    if rows == "grid+1":
        assert shape["warps"] == 8 and shape["ctas"] == n_sm + 1
    # n parents with one child each, and one parent with n children
    for n_par, C in ((n, 1), (min(n, 1), n)):
        _, parents, kids, t_min = _prefix_rows(dev, n_par, C, "mixed", seed=n)
        _hold_prefix(model, parents, kids, t_min, mm)


def _prefix_never_plain_or_cuda_cores(dev, monkeypatch, dt):
    def boom(*a, **k):
        raise AssertionError("the plain version or a CUDA-core prefix kernel ran on CUDA rows")

    for name in ("prefix_parent_plain", "prefix_child_plain", "_parent_simt", "_child_simt"):
        monkeypatch.setattr(pre, name, boom)
    monkeypatch.setattr(fused_rnn, "graph_mpsrnn_logpsi_fused_plain", boom)
    model, parents, kids, t_min = _prefix_rows(dev, 32, 20, "mixed")
    before = _prefix_counts()
    pre.graph_mpsrnn_logpsi_fused_prefix(model, parents, kids, t_min, matmul_dtype=dt)
    pre.ReducePrefixForward(model, matmul_dtype=dt)(parents, kids, t_min)
    torch.cuda.synchronize()
    assert _prefix_counts() == tuple(b + 2 for b in before[:4]) + before[4:]


def test_bf16_prefix_rows_on_card_never_take_the_plain_version_or_the_cuda_cores(
        dev, monkeypatch):
    _prefix_never_plain_or_cuda_cores(dev, monkeypatch, torch.bfloat16)


def test_f32_prefix_rows_on_card_never_take_the_plain_version_or_the_cuda_cores(
        dev, monkeypatch):
    _prefix_never_plain_or_cuda_cores(dev, monkeypatch, torch.float32)


def test_vmc_step_with_eloc_prefix_on_card(dev):
    """The REDUCE children through the prefix kernels (one parent and one
    child launch, no flat launch), and the same energy as the flat step
    on the same generator (f32 forwards, 1e-4)."""
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    out = {}
    for prefix in (False, True):
        model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                            dtype=torch.float32, device=dev,
                            generator=torch.Generator().manual_seed(0))
        sampler = ARSampler(8, 2, 2, n_sample=20_000, capacity=36)
        vmc = VMC(model, system, sampler, VMCConfig(
            lr=0.05, eloc_method="reduce", eloc_k_det=8, eloc_n_stoch=4,
            fused_matmul_dtype="f32", eloc_prefix=prefix))
        before = (pre.PARENT_LAUNCHES.n, pre.CHILD_LAUNCHES.n, fused_rnn.LAUNCHES.n)
        out[prefix] = vmc.step(torch.Generator(device=dev).manual_seed(1), 1.0)
        torch.cuda.synchronize()
        after = (pre.PARENT_LAUNCHES.n, pre.CHILD_LAUNCHES.n, fused_rnn.LAUNCHES.n)
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 0] if prefix else [0, 0, 1])
    assert math.isfinite(out[True]["energy"].item())
    assert abs(out[True]["energy"].item() - out[False]["energy"].item()) < 1e-4


def test_vmc_step_with_eloc_dedup_on_card(dev):
    """REDUCE with ``eloc_dedup_max``: one tensor-core launch per step on the
    distinct rows, and the step of the same generator without it (bf16
    forwards; the kernel rounds each row alone, so the rows agree within
    the bf16 rule of ``chip_smoke.hold_rows`` and the energies to 1e-4)."""
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    out, params = {}, {}
    for cap in (None, 20_000):
        model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                            dtype=torch.float32, device=dev,
                            generator=torch.Generator().manual_seed(0))
        sampler = ARSampler(8, 2, 2, n_sample=20_000, capacity=36)
        vmc = VMC(model, system, sampler, VMCConfig(
            lr=0.05, eloc_method="reduce", eloc_k_det=8, eloc_n_stoch=4, eloc_dedup_max=cap))
        before = fused_rnn.MMA_LAUNCHES.n
        out[cap] = vmc.step(torch.Generator(device=dev).manual_seed(1), 1.0)
        torch.cuda.synchronize()
        assert fused_rnn.MMA_LAUNCHES.n - before == 1
        params[cap] = {k: p.detach().clone() for k, p in model.named_parameters()}
    e0, e1 = out[None]["energy"].item(), out[20_000]["energy"].item()
    assert math.isfinite(e1) and abs(e1 - e0) <= 1e-4 * max(1.0, abs(e0))
    for k, p in params[None].items():
        assert (params[20_000][k] - p).abs().max().item() <= 1e-4, k
    with pytest.raises(OverflowError):
        VMC(model, system, ARSampler(8, 2, 2, n_sample=20_000, capacity=36), VMCConfig(
            eloc_method="reduce", eloc_k_det=8, eloc_n_stoch=4, eloc_dedup_max=1)).step(
            torch.Generator(device=dev).manual_seed(1), 1.0)


def test_cuda_kernel_f32_matches_log_psi(dev):
    """The f32 kernel against the model's own forward (phase mod 2π)."""
    model, dets = _model("fe2s2-dcut48", dev)
    bits = torch.as_tensor(dets, device=dev)
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=torch.float32)
    ref = model.log_psi(bits).detach()
    assert (k[:, 0] - ref[:, 0]).abs().max().item() < 1e-4
    d = (torch.polar(torch.ones_like(k[:, 1]), k[:, 1])
         - torch.polar(torch.ones_like(ref[:, 1]), ref[:, 1])).abs().max().item()
    assert d < 1e-3


def test_vmc_steps_on_card_launch_the_kernel(dev):
    """20 steps on the 4-site Hubbard chain: one tensor-core kernel launch
    per step and a falling, finite energy."""
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device=dev,
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(8, 2, 2, n_sample=20_000, capacity=36)
    before = (fused_rnn.LAUNCHES.n, fused_rnn.MMA_LAUNCHES.n)
    hist = VMC(model, system, sampler, VMCConfig(lr=0.05)).run(
        torch.Generator(device=dev).manual_seed(1), 20)
    # the default bf16 forward: the tensor-core kernel
    assert (fused_rnn.LAUNCHES.n - before[0], fused_rnn.MMA_LAUNCHES.n - before[1]) == (20, 20)
    assert all(math.isfinite(e) for e in hist)
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.05, hist


def test_scheduled_adamw_run_checkpoint_and_resume_on_card(dev, tmp_path):
    """The training run's loop on the card (the 4-site Hubbard chain): an
    exponential lr schedule, AdamW, the EMA and exact weights for 4 steps
    with a checkpoint every 2; a second VMC on other weights restores the
    last one bit for bit (parameters, Adam moments and count, schedule
    count, EMA, history) and resumes from it for 2 more finite steps at
    the scheduled rates of counts 4 and 5, through the tensor-core
    kernel."""
    from pynqs_tpu_torch.optim.schedule import exponential_decay
    from pynqs_tpu_torch.utils.checkpoint import load_checkpoint

    system = System.hubbard_1d(4, 2, 2, u=4.0)
    sched = exponential_decay(0.05, 4, 0.1)

    def vmc(seed, path):
        model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                            dtype=torch.float32, device=dev,
                            generator=torch.Generator().manual_seed(seed))
        sampler = ARSampler(8, 2, 2, n_sample=20_000, capacity=40, exact_weights=True)
        return VMC(model, system, sampler, VMCConfig(
            lr=sched, optimizer="adamw", eloc_method="reduce", eloc_k_det=8, eloc_n_stoch=4,
            clip_grad=1.0, ema_decay=0.9, checkpoint_path=str(path), checkpoint_interval=2))

    a = vmc(0, tmp_path / "a.pkl")
    lrs = []
    a.run(torch.Generator(device=dev).manual_seed(1), 4,
          callback=lambda it, info: lrs.append(info["lr"]))
    assert lrs == [sched(k) for k in range(4)] and len(a.history) == 4
    ck = load_checkpoint(str(tmp_path / "a.pkl"))
    assert ck["step"] == 3 and int(ck["opt_state"][2][0]) == 4
    b = vmc(5, tmp_path / "b.pkl")
    b.restore(str(tmp_path / "a.pkl"))
    named = dict(b.model.named_parameters())
    adam = ck["opt_state"][0]
    for k, p in named.items():
        assert p.device.type == dev.type
        assert np.array_equal(p.detach().cpu().numpy(), ck["params"][k]), k
        assert np.array_equal(b.ema_params[k].cpu().numpy(), ck["ema"][k]), k
        st = b.opt.state[p]
        assert np.array_equal(st["exp_avg"].cpu().numpy(), adam[1][k]), k
        assert np.array_equal(st["exp_avg_sq"].cpu().numpy(), adam[2][k]), k
        assert int(st["step"]) == 4
    assert b.count == 4 and b.history == a.history
    ck2 = str(tmp_path / "a2.pkl")
    shutil.copy(tmp_path / "a.pkl", ck2)
    before = fused_rnn.MMA_LAUNCHES.n
    lrs = []
    b.run(torch.Generator(device=dev).manual_seed(2), 2, resume_from=ck2,
          callback=lambda it, info: lrs.append(info["lr"]))
    assert fused_rnn.MMA_LAUNCHES.n > before
    assert lrs == [sched(4), sched(5)] and b.count == 6
    assert len(b.history) == 6 and all(math.isfinite(e) for e in b.history)
    assert b.history[:4] == a.history


def _pair_inputs(sym, dt, idx, dev, B=64, n_u=435, n_v=45, npair=780, seed=0, lo=0, hi=None):
    """Indices drawn from [lo, hi) (default [0, npair)); outside
    [0, npair) the kernel writes NaN."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((npair, npair))
    if sym:
        h = h + h.T
    hi = npair if hi is None else hi
    po = rng.integers(lo, hi, (B, n_u))
    pv = rng.integers(lo, hi, (B, n_v))
    return (torch.as_tensor(po, dtype=idx, device=dev), torch.as_tensor(pv, dtype=idx, device=dev),
            torch.as_tensor(h, dtype=dt, device=dev), h, po, pv)


# (B, n_u, n_v): the flagship's odd n_u·n_v in 3 bands of each variant;
# one sample; n_u and n_v below one band; band counts that divide
# neither n_u nor n_v; no sample
PAIR_SHAPES = {"flagship": (64, 435, 45), "B1": (1, 435, 45), "small": (3, 7, 5),
               "ragged": (25, 170, 17), "B0": (0, 435, 45)}


@pytest.mark.parametrize("shape", list(PAIR_SHAPES))
@pytest.mark.parametrize("idx", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("variant", ps.VARIANTS)
def test_pair_select_kernel_equals_plain_bitwise(variant, sym, dt, idx, shape, dev):
    """One launch per call (none for an empty output); bitwise the plain
    version (a gather does no arithmetic) and the advertised
    hpair[po, pv], also for a non-symmetric hpair."""
    B, n_u, n_v = PAIR_SHAPES[shape]
    po, pv, h, h_np, po_np, pv_np = _pair_inputs(sym, dt, idx, dev, B, n_u, n_v)
    before = ps.LAUNCHES[variant].n
    k = ps.pair_select_w(po, pv, h, variant=variant)
    torch.cuda.synchronize()
    assert ps.LAUNCHES[variant].n == before + (B > 0)
    assert k.shape == (B, n_u, n_v) and k.dtype == dt
    assert torch.equal(k, ps.pair_select_w_plain(po, pv, h, variant=variant))
    ref = h_np[po_np[:, :, None], pv_np[:, None, :]]
    assert torch.equal(k.cpu(), torch.as_tensor(ref, dtype=dt))


@pytest.mark.parametrize("shape", ["flagship", "small", "ragged"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", ps.VARIANTS)
def test_pair_select_out_of_range_indices_give_nan(variant, dt, shape, dev):
    """An index outside [0, npair) gives NaN at exactly the positions it
    reaches, and every other value is the plain version's."""
    B, n_u, n_v = PAIR_SHAPES[shape]
    po, pv, h, *_ = _pair_inputs(False, dt, torch.int64, dev, B, n_u, n_v, seed=3, lo=-3,
                                 hi=783)
    npair = h.shape[0]
    po[0, 0], pv[-1, -1] = -1, npair  # at least one of each side
    k = ps.pair_select_w(po, pv, h, variant=variant)
    ok = (((po >= 0) & (po < npair))[:, :, None] & ((pv >= 0) & (pv < npair))[:, None, :])
    assert 0 < int((~ok).sum()) < ok.numel()
    plain = ps.pair_select_w_plain(po.clamp(0, npair - 1), pv.clamp(0, npair - 1), h,
                                   variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(k), ~ok)
    assert torch.equal(k[ok], plain[ok])


@pytest.mark.parametrize("shape", ["flagship", "small", "ragged"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", ps.VARIANTS)
def test_pair_select_band_kernel_equals_the_earlier_gather(variant, dt, shape, dev):
    """The band kernel (reading hpair^T) and the earlier gather kernel
    (timing only, reading hpair) give the same bits on a non-symmetric
    hpair, out-of-range NaNs included; the gather counts no launch."""
    B, n_u, n_v = PAIR_SHAPES[shape]
    po, pv, h, *_ = _pair_inputs(False, dt, torch.int32, dev, B, n_u, n_v, seed=4, lo=-1,
                                 hi=781)
    before = {v: c.n for v, c in ps.LAUNCHES.items()}
    g = ps._launch_gather(po, pv, h, variant)
    torch.cuda.synchronize()
    assert {v: c.n for v, c in ps.LAUNCHES.items()} == before
    k = ps.pair_select_w(po, pv, h, variant=variant)
    torch.cuda.synchronize()
    assert g.shape == k.shape and torch.equal(torch.isnan(g), torch.isnan(k))
    assert torch.equal(g.nan_to_num(), k.nan_to_num())


def test_pair_select_on_cuda_never_calls_the_plain_version(dev, monkeypatch):
    """CUDA tensors reach the band kernel or raise: never the plain
    version, never the earlier gather."""
    def boom(*a, **k):
        raise AssertionError("the plain version or the earlier gather ran on CUDA tensors")

    monkeypatch.setattr(ps, "pair_select_w_plain", boom)
    monkeypatch.setattr(ps, "_launch_gather", boom)
    po, pv, h, *_ = _pair_inputs(True, torch.float32, torch.int64, dev)
    for variant in ps.VARIANTS:
        ps.pair_select_w(po, pv, h, variant=variant)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        ps.pair_select_w(po.cpu(), pv, h)
    with pytest.raises(ValueError):
        ps.pair_select_w(po.int(), pv, h)


def test_comb_hij_dense_on_card_equals_sector_form(dev):
    """f32 tables at sorb 20: the dense pair matrix through the kernel
    (one launch of its lane variant, whatever ``pair_select`` names)
    gives bitwise the sector blocks' matrix elements."""
    rng = np.random.default_rng(1)
    h1e = rng.standard_normal((20, 20)) * 0.1
    system = System.from_integrals((h1e + h1e.T) / 2,
                                   rng.standard_normal(triangle_size(20)) * 0.01, 20, 5, 5)
    t = system.tables(dev, torch.float32)
    bits = torch.as_tensor(_rand_dets(512, 20, 5, 5, 2), device=dev)
    _, ref = comb_hij(bits, *t.astuple(), t.hpair_sect, table=system.excitation)
    for pair_select in ("auto", "xla", "pallas"):
        before = {v: c.n for v, c in ps.LAUNCHES.items()}
        _, out = comb_hij(bits, *t.astuple(), t.hpair, table=system.excitation,
                          pair_select=pair_select)
        torch.cuda.synchronize()
        assert ps.LAUNCHES["lane"].n == before["lane"] + 1
        assert ps.LAUNCHES["rowrow"].n == before["rowrow"]
        assert torch.equal(out, ref)


def _nqsci_setup(dev, mm, ci_chunk=64):
    """NqsCi on a 12-orbital stand-in (the DAG with tensor coupling, dcut
    8, f32) with 8 CI determinants, its gradient-free forwards the fused
    forward in ``mm`` ("f32", "bf16" or "xla" = model.log_psi)."""
    from pynqs_tpu_torch.ci.nqs_ci import NqsCi, NqsCiConfig
    from pynqs_tpu_torch.scripts.fe2s2_ci_polish import polish_forward

    rng = np.random.default_rng(3)
    h1e = rng.standard_normal((12, 12)) * 0.2
    system = System.from_integrals((h1e + h1e.T) / 2,
                                   rng.standard_normal(triangle_size(12)) * 0.05, 12, 3, 3)
    model = flagship_model(system, 8, use_tensor=True, max_preds=2, device=dev,
                           generator=torch.Generator().manual_seed(4))
    d_bits = _all_dets(12, 3, 3)[::50][:8]
    cfg = NqsCiConfig(n_sample=20_000, capacity=256, ci_chunk=ci_chunk, eloc_batch=32,
                      lr=1e-2, log_every=0)
    return model, NqsCi(model, system, d_bits, cfg, eval_fwd=polish_forward(model, mm))


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_nqsci_iteration_on_card_launches_kernel_1(mm, dev):
    """One NqsCi iteration on the card: the gradient-free forwards launch
    kernel #1 on the tensor cores in their mode only (f32: its 3xTF32
    mode; bf16: its bf16 mode), the iteration is finite and moves the
    parameters, and h_nn and H_cn agree with model.log_psi's on the same
    draw (f32 1e-4, bf16 5e-2 relative to the largest |H_cn|)."""
    model, nq = _nqsci_setup(dev, mm)
    before = _mode_counts()
    bits, w = nq.draw(torch.Generator(device=dev).manual_seed(1))
    eloc, h_nn = nq.eloc_eval(bits, w)
    h_cn, ci_mass = nq.hcn_eval()
    torch.cuda.synchronize()
    n, n_mma, n_f32 = (a - b for a, b in zip(_mode_counts(), before))
    assert n > 0 and (n_mma, n_f32) == ((n, 0) if mm == "bf16" else (0, n)), (n, n_mma, n_f32)
    nq.eval_fwd = model.log_psi
    eloc_x, h_nn_x = nq.eloc_eval(bits, w)
    h_cn_x, mass_x = nq.hcn_eval()
    tol = 1e-4 if mm == "f32" else 5e-2
    scale = float(h_cn_x.abs().max())
    assert abs(float(h_nn) - float(h_nn_x)) <= tol * max(1.0, abs(float(h_nn_x)))
    assert float((h_cn - h_cn_x).abs().max()) <= tol * scale
    assert abs(float(ci_mass) - float(mass_x)) <= tol
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    e_tot, c = nq.solve(h_nn, h_cn)
    nq.grad_step(bits, w, eloc, h_nn, c, 1.0)
    assert math.isfinite(e_tot) and np.isfinite(c).all()
    assert any(not torch.equal(p0[k], p) for k, p in model.named_parameters())
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_nqsci_chunked_gradient_on_card_equals_one_chunk(dev):
    """The H_cn and sampled-row backward in chunks of 64 rows against one
    chunk, f32 on the card: within 1e-5 of the largest gradient entry."""
    grads = []
    for chunk in (64, None):
        _, nq = _nqsci_setup(dev, "f32", chunk)
        bits, w = nq.draw(torch.Generator(device=dev).manual_seed(1))
        eloc, h_nn = nq.eloc_eval(bits, w)
        _, c = nq.solve(h_nn, nq.hcn_eval()[0])
        grads.append(nq.gradients(bits, w, eloc, h_nn, c, 1.0))
    assert nq._ci_flat.shape[0] > 64 * 10
    big = max(float(g.abs().max()) for g in grads[1])
    assert big > 0 and max(float((a - b).abs().max()) for a, b in zip(*grads)) <= 1e-5 * big


# ---------------- SR on the card ----------------


def test_sr_solvers_agree_in_f64_on_card(dev):
    """Dense = blocked with one block (1e-10), CG with n_cg = 2P = dense
    (1e-8) at damping 1e-2; the per-tensor blocks finite."""
    from pynqs_tpu_torch.grad import sr

    m = GraphMPSRNN(8, 2, 2, dcut=2, phase_mode="arg", norm_mode="mpsrnn", dtype=torch.float64,
                    device=dev, generator=torch.Generator().manual_seed(3))
    P = sum(p.numel() for p in m.parameters())
    rng = np.random.default_rng(3)
    bits = torch.as_tensor(_all_dets(8, 2, 2), device=dev)
    w = rng.random(bits.shape[0])
    w[::5] = 0.0
    w = torch.as_tensor(w / w.sum(), device=dev)
    el = torch.as_tensor(rng.standard_normal((bits.shape[0], 2)), device=dev)
    dense = sr.sr_gradient(m, bits, w, el, damping=1e-2)
    one = sr.sr_gradient_blocked(m, bits, w, el, damping=1e-2,
                                 blocks={n: 0 for n, _ in m.named_parameters()})
    cg = sr.sr_gradient_cg(m, bits, w, el, damping=1e-2, n_cg=2 * P)
    per = sr.sr_gradient_blocked(m, bits, w, el, damping=1e-2)
    big = max(float(v.abs().max()) for v in dense.values())
    for k, v in dense.items():
        assert v.device.type == "cuda" and torch.isfinite(per[k]).all()
        assert float((one[k] - v).abs().max()) <= 1e-10 * big, k
        assert float((cg[k] - v).abs().max()) <= 1e-8 * big, k


def test_safe_atan2_forward_mode_on_card(dev):
    from pynqs_tpu_torch.ops.cplx import safe_atan2

    g = torch.Generator(device=dev).manual_seed(4)
    y, x, dy, dx = (torch.randn(256, generator=g, device=dev, dtype=torch.float64)
                    for _ in range(4))
    x[:3] = 0.0
    y[:2] = 0.0
    _, t = torch.func.jvp(safe_atan2, (y, x), (dy, dx))
    m2 = torch.clamp(x * x + y * y, min=1e-12)
    assert t.device.type == "cuda"
    torch.testing.assert_close(t, (x * dy - y * dx) / m2, rtol=1e-14, atol=0)
    gy, gx = torch.func.vmap(torch.func.grad(safe_atan2, argnums=(0, 1)))(y, x)
    torch.testing.assert_close(gy, x / m2, rtol=1e-14, atol=0)
    torch.testing.assert_close(gx, -y / m2, rtol=1e-14, atol=0)


def test_cg_sr_step_on_card_launches_kernel_1(dev):
    """One CG-SR + SGD step on a dcut-8 chain: its REDUCE forward is one
    tensor-core launch, the energy finite, every parameter moved by the
    SGD update and none by the plain gradient's backward (not run)."""
    system = System.hubbard_1d(6, 3, 3, u=4.0)
    model = GraphMPSRNN(12, 3, 3, dcut=8, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device=dev,
                        generator=torch.Generator().manual_seed(5))
    cfg = VMCConfig(lr=0.01, optimizer="sgd", use_sr=True, sr_solver="cg", sr_n_cg=10,
                    eloc_method="reduce", eloc_k_det=16, eloc_n_stoch=4, clip_grad=1.0)
    v = VMC(model, system, ARSampler(12, 3, 3, n_sample=20_000, capacity=400), cfg)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    before = _mode_counts()
    out = v.step(torch.Generator(device=dev).manual_seed(6), 1.0)
    after = _mode_counts()
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (1, 1, 0)
    assert math.isfinite(float(out["energy"])) and abs(float(out["w_sum"]) - 1) < 1e-5
    assert any(not torch.equal(p0[k], p) for k, p in model.named_parameters())
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("mm", ["bf16", "f32"])
def test_dp128_forward_matches_plain_on_card(mm, dev):
    """dcut 128 (dp 128, the widest the tensor-core walk takes) on 16,384
    random rows, held by chip_smoke's ``hold_rows`` (in bf16 the f32
    evaluation counts among the references, as in its phase 15)."""
    model = GraphMPSRNN(40, 15, 15, dcut=128, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device=dev,
                        generator=torch.Generator().manual_seed(7))
    x = torch.as_tensor(_rand_dets(16384, 40, 15, 15, 8), device=dev)
    dt = torch.bfloat16 if mm == "bf16" else torch.float32
    T = fused_rnn.pack_tables(model)
    before = _mode_counts()
    k = fused_rnn.graph_mpsrnn_logpsi_fused(model, x, matmul_dtype=dt, tables=T)
    after = _mode_counts()
    assert after[0] - before[0] == 1 and after[1 if mm == "bf16" else 2] - before[
        1 if mm == "bf16" else 2] == 1
    p = fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, x, matmul_dtype=dt, tables=T)
    q = [fused_rnn.graph_mpsrnn_logpsi_fused_plain(
        model, x, matmul_dtype=dt, tables={key: t.double() for key, t in T.items()})]
    if mm == "bf16":
        q.append(fused_rnn.graph_mpsrnn_logpsi_fused_plain(model, x, matmul_dtype=torch.float32,
                                                           tables=T))
    tol = (1e-4, 1e-3) if mm == "f32" else (1e-1, 1e-1)
    ok, held, st = smoke.hold_rows(k, p, q, tol)
    assert ok, (held, st)



# ---------------- the other ansätze (ROADMAP A8) ----------------


def _a8_model(kind, dev, seed=0):
    """Every A8 model at a small size, f64, seeded."""
    from pynqs_tpu_torch import models as M

    g = torch.Generator().manual_seed(seed)
    kw = dict(dtype=torch.float64, device=dev, generator=g)
    return {
        "rbm": lambda: M.RBM(8, param_type="complex", activation="cos", **kw),
        "jastrow": lambda: M.Jastrow(8, **kw),
        "ising": lambda: M.IsingRBM(8, param_type="complex", **kw),
        "dbm": lambda: M.DBM(8, nh1=6, nh2=5, **kw),
        "arrbm": lambda: M.ARRBM(8, 2, 2, nh=6, **kw),
        "arrbm2": lambda: M.ARRBM2(8, 2, 2, nh=6, **kw),
        "rnn": lambda: M.RNNWavefunction(8, 2, 2, hidden=8, **kw),
        "decoder": lambda: M.DecoderWavefunction(8, 2, 2, norm_method="softmax-sign", **kw),
        "mpsdec": lambda: M.MPSDecoder(8, 2, 2, pmode="spm", **kw),
        "mps": lambda: M.MPSWavefunction(8, dcut=4, **kw),
        "spinproj": lambda: M.SpinProjected(M.RNNWavefunction(8, 2, 2, hidden=8, **kw), -1),
    }[kind]()


@pytest.mark.parametrize("kind", ["rbm", "jastrow", "ising", "dbm", "arrbm", "arrbm2", "rnn",
                                  "decoder", "mpsdec", "mps", "spinproj"])
def test_a8_log_psi_on_card_equals_cpu(kind, dev):
    """Each model's log_psi on the card equals the same model's on the CPU
    in f64 (log|ψ| and the phase mod 2π to 1e-10)."""
    m_gpu, m_cpu = _a8_model(kind, dev), _a8_model(kind, "cpu")
    bits = torch.as_tensor(_all_dets(8, 2, 2))
    with torch.no_grad():
        got = m_gpu.log_psi(bits.to(dev)).cpu()
        want = m_cpu.log_psi(bits)
    assert (got[:, 0] - want[:, 0]).abs().max() < 1e-10
    assert torch.remainder(got[:, 1] - want[:, 1] + math.pi, 2 * math.pi).sub(math.pi).abs(
    ).max() < 1e-10


@pytest.mark.parametrize("kind", ["arrbm", "rnn", "decoder", "mpsdec"])
def test_a8_sampling_on_card(kind, dev):
    """One-site (ARRBM, RNN) and two-site (decoder, MPSDecoder: nested
    carries) DFS sampling on the card: rows unique and in the sector,
    Σcounts = n − dropped; the decoder's KV-cached conditionals along the
    drawn rows sum to 2·log|ψ| to 1e-10."""
    from pynqs_tpu_torch.sampler import ar
    from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp

    model = _a8_model(kind, dev, seed=1)
    n = 100_000
    bits, counts, dropped = ar.ar_sampling_dfs(
        model, n, capacity=32, n_group=2, split_depth=4 // model.sites_per_step,
        generator=torch.Generator(device=dev).manual_seed(2))
    live = counts > 0
    rows = bits[live]
    assert bits.device.type == "cuda" and int(counts.sum()) == n - int(dropped)
    assert (rows[:, 0::2].sum(-1) == 2).all() and (rows[:, 1::2].sum(-1) == 2).all()
    keys = (rows.long() << torch.arange(8, device=dev)).sum(-1)
    assert torch.unique(keys).numel() == rows.shape[0]
    nps, _, n_steps, order = ar._layout(model)
    with torch.no_grad():
        carry = model.ar_init(rows.shape[0])
        prev = torch.zeros(rows.shape[0], dtype=torch.long, device=dev)
        ua, ub = prev.clone(), prev.clone()
        tot = torch.zeros(rows.shape[0], dtype=torch.float64, device=dev)
        r = rows.long()
        for k in range(n_steps):
            logp, carry = model.ar_step(carry, k, prev)
            logp = apply_mask_logp(logp, ar._step_mask(model, k, ua, ub))
            v = r[:, 2 * order[k]] + 2 * r[:, 2 * order[k] + 1] if nps == 2 else r[:, k]
            tot += logp.gather(-1, v[:, None])[:, 0]
            _, ua, ub = ar._place(model, k, r.clone(), ua, ub, v)
            prev = v
        assert (tot - 2 * model.log_psi(rows)[:, 0]).abs().max() < 1e-10


def _dp_vmc(mesh, dev):
    """Two REDUCE steps of a small chain (kernel #1 in bf16) with the AR
    sampler over ``mesh`` (none: one process)."""
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device=dev,
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(8, 2, 2, n_sample=10_000, capacity=64, mesh=mesh)
    vmc = VMC(model, system, sampler,
              VMCConfig(lr=1e-2, optimizer="adamw", eloc_method="reduce", eloc_k_det=4,
                        eloc_n_stoch=4, log_every=10**6))
    fused_rnn.MMA_LAUNCHES.reset()
    hist = vmc.run(torch.Generator(device=dev).manual_seed(3), 2)
    return hist, {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}


def _gloo_rank(mesh):
    from pynqs_tpu_torch.parallel import replicated_check

    hist, params = _dp_vmc(mesh, mesh.device)
    spread = replicated_check(mesh, {k: torch.as_tensor(v) for k, v in params.items()})
    return {"history": hist, "launches": fused_rnn.MMA_LAUNCHES.n, "spread": spread}


def test_world_one_nccl_step_equals_the_step_without_a_mesh(dev, tmp_path):
    import torch.distributed as dist

    from pynqs_tpu_torch.parallel import init_mesh

    mesh = init_mesh("nccl", f"file://{tmp_path / 'store'}", 0, 1, dev)
    try:
        h1, p1 = _dp_vmc(mesh, dev)
        l1 = fused_rnn.MMA_LAUNCHES.n
    finally:
        dist.destroy_process_group()
    h0, p0 = _dp_vmc(None, dev)
    assert l1 > 0 and h1 == h0
    for k in p0:
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)


def test_two_gloo_ranks_on_one_card_keep_their_parameters_equal(dev, tmp_path):
    from pynqs_tpu_torch.parallel import run_ranks

    out = run_ranks(_gloo_rank, 2, backend="gloo", device="cuda", timeout=300,
                    rendezvous_dir=str(tmp_path))
    assert out[0]["history"] == out[1]["history"]
    assert all(r["spread"] == 0.0 and r["launches"] > 0 for r in out)
    assert all(math.isfinite(e) for e in out[0]["history"])


def test_entry_launches_kernel_1(dev):
    from pynqs_tpu_torch.entry import entry

    fn, args = entry()
    fused_rnn.MMA_LAUNCHES.reset()
    e = float(fn(*args))
    torch.cuda.synchronize()
    assert fused_rnn.MMA_LAUNCHES.n > 0 and math.isfinite(e)
