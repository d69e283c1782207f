"""The entry points on the CPU: ``dryrun_multichip`` over two gloo ranks,
its refusals, a profiled VMC run's trace, and ``bench.run`` at a small
size."""

import json

import numpy as np
import pytest
import torch

from pynqs_tpu_torch import bench
from pynqs_tpu_torch.entry import dryrun_multichip
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.logging import read_log
from pynqs_tpu_torch.utils.system import System


def test_dryrun_multichip_over_two_cpu_ranks(tmp_path):
    out = dryrun_multichip(2, device="cpu", timeout=120, rendezvous_dir=str(tmp_path))
    assert len(out) == 2 and len(out[0]["history"]) == 1
    assert np.isfinite(out[0]["history"]).all()
    assert out[0]["history"] == out[1]["history"]  # every rank logs the global energy


def test_dryrun_multichip_never_moves_to_the_cpu(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 cards"):
        dryrun_multichip(2)
    with pytest.raises(ValueError, match="gloo"):
        dryrun_multichip(2, device="cpu", backend="nccl")


def test_profiled_run_writes_a_trace_with_the_stage_ranges(tmp_path):
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu", generator=torch.Generator().manual_seed(0))
    cfg = VMCConfig(lr=1e-2, log_every=10**6, eloc_method="reduce", eloc_k_det=4,
                    eloc_n_stoch=2, profile_dir=str(tmp_path / "prof"), profile_iters=2,
                    fused_forward=True, log_path=str(tmp_path / "log"))
    sampler = ARSampler(8, 2, 2, n_sample=1000, capacity=36, dfs_n_group=2, dfs_split_depth=2)
    VMC(model, system, sampler, cfg).run(torch.Generator().manual_seed(1), 4)
    trace = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    for rng in ("vmc.sample", "vmc.eloc", "vmc.grad", "vmc.update", "ar.root", "ar.groups",
                "ar.compact", "hamiltonian.comb_hij", "eloc.select", "fused_rnn.forward",
                "fused_rnn.count_distinct", "grad.forward", "grad.backward"):
        assert names.count(rng) == 2, rng  # iterations 2 and 3 only (one chunk each)
    # the fused forward's rows over the traced iterations, as one record beside the trace
    rec = [r for r in read_log(str(tmp_path / "log")) if "fused_rows" in r]
    assert len(rec) == 1 and rec[0]["trace"].endswith("trace_rank0.json")
    assert 0 < rec[0]["fused_distinct"] <= rec[0]["fused_rows"]
    assert rec[0]["fused_rows"] == 2 * 72 * (1 + 4 + 2)  # 2 iterations of 72 rows x 7 forwards


@pytest.mark.parametrize("mode", ["flat", "prefix"])
def test_bench_run_prints_its_line(mode, capsys):
    system = System.hubbard_1d(8, 3, 3, u=4.0)
    model = GraphMPSRNN(16, 3, 3, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                        dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    res = bench.run(system, model, B=32, k_det=16, n_stoch=4, n_rep=2, device="cpu",
                    mode=mode, dedup=mode == "flat", n_sample=20_000, capacity=128)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "flagship_reduce_eloc_hij_terms_per_sec_per_chip"
    assert line["unit"] == "terms/s" and line["value"] > 0
    assert "vs_baseline" not in line  # no anchor: nothing measured one
    assert res["mode"] == mode and res["device"] == "cpu"
    assert (res["dedup_unique_max"] is not None) == (mode == "flat")
