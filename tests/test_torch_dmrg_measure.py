"""The measurement scripts through their ``main``s on the CPU, at a tiny
size on seeded stand-in integrals and test-written checkpoints:
``spin_subspace_eval`` (every reported energy and <S-S+> against the
dense Hamiltonian and S⁻S⁺ restricted to the captured set, built by the
independent oracle from the JAX package's integrals, to 1e-10),
``kdet_rebalance_check``, ``measure_unique_chunks`` and
``measure_dfs_r3``."""

import numpy as np
import pytest
import torch
from scipy.linalg import eigh

import oracle
from pynqs_tpu.ops.integrals import decompress_h2e

from pynqs_tpu_torch.ops.integrals import spin_raising
from pynqs_tpu_torch.scripts import (
    kdet_rebalance_check,
    measure_dfs_r3,
    measure_unique_chunks,
    spin_subspace_eval,
)
from pynqs_tpu_torch.utils.checkpoint import save_params
from pynqs_tpu_torch.utils.flagship import flagship_model, load_flagship_params
from test_torch_dmrg_scripts import stand_in


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoint(root, system, dcut, name, seed):
    """A seeded flagship chain's parameters under ``root/checkpoints``."""
    model = flagship_model(system, dcut, device="cpu", dtype=torch.float64,
                           generator=torch.Generator().manual_seed(seed))
    (root / "checkpoints").mkdir(exist_ok=True)
    path = root / "checkpoints" / name
    save_params(str(path), {k: p.detach() for k, p in model.named_parameters()})
    return str(path)


def test_spin_subspace_main_against_the_dense_oracle(tmp_path):
    system = stand_in(sorb=12, n=3, seed=2)
    ckpt = _checkpoint(tmp_path, system, 4, "chain.pkl", 0)
    out = spin_subspace_eval.main([ckpt, "--dcut", "4", "--n-sample", "3000", "--capacity", "64",
                                   "--split-depth", "3", "--batch", "64"],
                                  system=system, device="cpu")
    bits = out["bits"].numpy()
    assert 0 < out["n_set"] == len(bits) <= 400
    dets = [oracle.bits_to_det(b) for b in bits]
    H = oracle.dense_h(dets, system.h1e, decompress_h2e(system.h2e, 12))
    s1, s2 = spin_raising(12)
    S = oracle.dense_h(dets, s1, decompress_h2e(s2, 12))
    model = flagship_model(system, 4, device="cpu")
    model.load_numpy_params({k: np.asarray(v, np.float32)
                             for k, v in load_flagship_params(ckpt).items()})
    lp = model.log_psi(out["bits"]).detach().double().numpy()
    v = np.exp(lp[:, 0]) * np.exp(1j * lp[:, 1])
    v /= np.linalg.norm(v)

    def rq(A, u):
        return (np.vdot(u, A @ u) / np.vdot(u, u)).real

    b1 = S @ v
    b2 = S @ b1
    want = {"v": v, "p6": (6 * v - b1) / 6, "p6p20": (120 * v - 26 * b1 + b2) / 120}
    for k, u in want.items():
        e, ss = out["rows"][k]
        assert abs(e - (rq(H, u) + system.ecore)) < 1e-10, k
        assert abs(ss - rq(S, u)) < 1e-10, k
    B = np.stack([v, b1, b2], 1)
    A, M = B.conj().T @ H @ B, B.conj().T @ B
    w, c = eigh((A + A.conj().T) / 2, (M + M.conj().T) / 2)
    assert abs(out["rows"]["optimum"][0] - (w[0] + system.ecore)) < 1e-8
    assert abs(out["rows"]["optimum"][1] - rq(S, B @ c[:, 0])) < 1e-8


def test_kdet_rebalance_main(tmp_path, capsys, monkeypatch):
    system = stand_in(sorb=20, n=3, seed=3)
    _checkpoint(tmp_path, system, 6, "dcut6.pkl", 1)
    monkeypatch.setattr(kdet_rebalance_check, "N_DRAW", 100_000)
    monkeypatch.setattr(kdet_rebalance_check, "B", 64)
    out = kdet_rebalance_check.main(["--ckpt", "dcut6.pkl", "--dcut", "6", "--n-batches", "1",
                                     "--n-keys", "2"], system=system, device="cpu",
                                    root=str(tmp_path))
    assert set(out) == {(512, 128), (256, 64)}
    for c, s in out.items():
        assert all(np.isfinite(v) for v in s.values()) and s["rms"] >= abs(s["bias"]), c
    assert "batch-energy spread over keys" in capsys.readouterr().out


def test_measure_unique_chunks_main(tmp_path):
    system = stand_in(sorb=20, n=3, seed=4)
    _checkpoint(tmp_path, system, 4, "dcut4.pkl", 2)
    out = measure_unique_chunks.main(["checkpoints/dcut4.pkl", "1e5", "256", "64", "--dcut", "4"],
                                     system=system, device="cpu", root=str(tmp_path))
    assert out["rows"] == 64 * (1 + 512 + 128)
    assert len(out["unique"]) == -(-min(out["live"], 256) // 64)
    assert all(64 <= n <= out["rows"] for n in out["unique"])
    assert 0 <= out["dropped"] < 1 and 0 < out["kept"] <= 1


def test_measure_dfs_main(tmp_path, monkeypatch):
    system = stand_in(sorb=20, n=3, seed=5)
    _checkpoint(tmp_path, system, 4, "dcut4.pkl", 3)
    for k, v in (("CKPT", "checkpoints/dcut4.pkl"), ("DCUT", 4), ("PROFILE", (100_000, 512, 12)),
                 ("RUNS", ((100_000, 256, 3, 4, 64), (100_000, 256, 4, 2, 128)))):
        monkeypatch.setattr(measure_dfs_r3, k, v)
    out = measure_dfs_r3.main(system=system, device="cpu", root=str(tmp_path))
    assert len(out["live_per_depth"]) == 9  # depth capped at n_steps - 1
    assert out["live_per_depth"][0] <= 4
    for r in out["runs"]:
        assert 0 < r["live"] <= r["groups"] * r["capacity"] and 0 <= r["dropped"] < 1
