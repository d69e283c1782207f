"""Data-parallel AR sampling on the CPU over two gloo ranks (the port's
version of ``tests/test_parallel.py``'s sampling checks, without an
8-device JAX mesh).

One module-scoped spawn runs ``torch_dist_ranks.sampling_scenarios``:
``ar_sampling_sharded`` twice from one seed (an RNN wavefunction on 8
spin orbitals, 2α/2β, n 4e5, capacity 512 at tree height 3), the
same-tree ``ARSampler`` with and without ``max_unique`` from one
generator state, and ``mesh_mode="independent"`` (a GraphMPSRNN, n 4e5,
capacity 64 per rank).  Checked: the draws repeat bit for bit, the
ranks' rows are disjoint, the union follows the exact |ψ|² (total
variation ½Σ|f − p| < 0.01), the compaction keeps the max_unique
largest counts of both ranks with their weights renormalized, the
independent mode's merged rows are unique with counts summing to
n_sample, and the shared generator stays in sync.
"""

import numpy as np
import pytest
import torch

from pynqs_tpu_torch.parallel import run_ranks
from pynqs_tpu_torch.utils import fci

from torch_dist_ranks import _rnn, sampling_scenarios

SPACE = fci.fci_bits(8, 2, 2)  # 36 determinants


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(sampling_scenarios, 2, backend="gloo", device="cpu", timeout=240,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), num_threads=1)


def _exact_p(model):
    with torch.no_grad():
        la = model.log_psi(torch.as_tensor(SPACE))[:, 0].numpy()
    p = np.exp(2 * (la - la.max()))
    return p / p.sum()


def _tv(rows, w, p):
    idx = (rows[:, None, :] == SPACE[None]).all(-1).argmax(1)
    emp = np.zeros(SPACE.shape[0])
    np.add.at(emp, idx, w)
    return 0.5 * np.abs(emp / emp.sum() - p).sum()


def test_sharded_sampling_repeats_for_a_seed(ranks):
    for r in ranks:
        a, b = r["sharded"]
        np.testing.assert_array_equal(a["bits"], b["bits"])
        np.testing.assert_array_equal(a["counts"], b["counts"])
        assert a["dropped"] == b["dropped"] and a["sync"] and b["sync"]


def test_sharded_rows_are_disjoint_and_unbiased(ranks):
    runs = [r["sharded"][0] for r in ranks]
    assert runs[0]["dropped"] == runs[1]["dropped"] >= 0
    bits = np.concatenate([r["bits"] for r in runs])
    counts = np.concatenate([r["counts"] for r in runs])
    live = counts > 0
    assert counts.sum() + runs[0]["dropped"] == 400_000
    assert counts.sum() > 0.99 * 400_000
    assert len(np.unique(bits[live], axis=0)) == live.sum(), "duplicate rows across ranks"
    assert _tv(bits[live], counts[live].astype(float), _exact_p(_rnn())) < 0.01


def test_global_compaction_keeps_the_largest_counts(ranks):
    c = [r["compact"] for r in ranks]
    full_bits = np.concatenate([x["full_bits"] for x in c])
    full_w = np.concatenate([x["full_w"] for x in c])
    bits = np.concatenate([x["bits"] for x in c])
    w = np.concatenate([x["w"] for x in c])
    assert bits.shape[0] == 16 and abs(w.sum() - 1.0) < 1e-12 and (w > 0).all()
    assert len(np.unique(bits, axis=0)) == 16
    live = full_w > 0  # dead rows of the AR buffer may repeat live rows' bits
    full_bits, full_w = full_bits[live], full_w[live]
    key = [tuple(r) for r in full_bits]
    kept = [key.index(tuple(r)) for r in bits]
    dropped = np.setdiff1d(np.arange(len(key)), kept)
    assert full_w[kept].min() >= full_w[dropped].max()
    np.testing.assert_allclose(w, full_w[kept] / full_w[kept].sum(), rtol=1e-12, atol=0)
    assert c[0]["dropped_frac"] == c[1]["dropped_frac"] > 0


def test_independent_mode_merges_the_ranks_uniquely(ranks):
    from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN

    ind = [r["independent"] for r in ranks]
    bits = np.concatenate([x["bits"] for x in ind])
    w = np.concatenate([x["w"] for x in ind])
    live = w > 0
    assert len(np.unique(bits[live], axis=0)) == live.sum()
    assert ind[0]["n_unique"] == ind[1]["n_unique"] == live.sum()
    assert ind[0]["dropped_frac"] == ind[1]["dropped_frac"] == 0.0  # counts sum to n_sample
    assert abs(w.sum() - 1.0) < 1e-12 and all(x["sync"] for x in ind)
    gm = GraphMPSRNN(8, 2, 2, dcut=6, dtype=torch.float64, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    assert _tv(bits[live], w[live], _exact_p(gm)) < 0.01
