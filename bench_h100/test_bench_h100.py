"""Tests of the benchmark harness (CPU, tiny sizes; the card's tests carry
the ``gpu`` marker and skip without one).

    python -m pytest bench_h100/test_bench_h100.py -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from bench_h100 import reference as ref  # noqa: E402
from bench_h100 import run  # noqa: E402
from bench_h100.readers import roofline  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TINY_CFG = {"model": "GraphMPSRNN", "source": "test", "sorb": 12, "noa": 3, "nob": 3, "dcut": 8,
            "max_preds": 1, "use_tensor": False, "dcut_cmpr": 4, "fwd_dtype": "bf16",
            "weights": None}
TINY_VMC = {"driver": "vmc_step", "n_sample": 4000, "capacity": 64, "n_group": 2,
            "split_depth": 2, "capacity_root": 64, "max_unique": 96, "k_det": 16, "n_stoch": 8,
            "topk": "exact", "eloc_batch": 32, "grad_batch": 40, "lr": 2e-3, "lr_end": 1e-4,
            "iters": 100, "clip": 0.1, "checked_steps": 3, "checked_top": 4, "checked_rows": 24,
            "chi2_min_count": 20}
TINY_GFMC = {"driver": "gfmc", "n_walkers": 24, "n_sample": 4000, "init_capacity": 64,
             "branch_interval": 3, "p_steps": 2, "gamma": 0.0, "check_block": 8,
             "check_chunks": 1, "check_rows": 512, "check_tail": 64}
# generous limits: a sound tiny run reads far below them, each planted fault far above
TINY_LIMITS = {"vmc": {"eloc_rel_med": 1e-4, "eloc_w_abs": 1e-4, "energy_gap": 1e-6,
                       "sampler_chi2": 8.0, "selection_faults": 0,
                       "grad_gap": 1e-3, "update_gap": 1e-2},
               "gfmc": {"logpsi_gap": 1e-4, "logpsi_over": 0.01, "logpsi_row_tol": 0.01,
                        "eloc_gap": 1e-4, "b_gap": 1e-4, "egen_gap": 1e-5, "move_faults": 0}}


def tiny_root(tmp_path):
    """A checkout-like directory holding a copy of the harness's data
    folders and a BENCHMARK.json of two tiny cells."""
    here = tmp_path / "bench_h100"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), here / sub)

    def put(path, obj):
        path.write_text(json.dumps(obj))

    put(here / "configs" / "tiny_chain.json", TINY_CFG)
    put(here / "configs" / "tiny_dag.json", dict(TINY_CFG, max_preds=2, use_tensor=True))
    put(here / "traffic" / "tiny_vmc.json", TINY_VMC)
    put(here / "traffic" / "tiny_gfmc.json", TINY_GFMC)
    put(here / "limits" / "tiny_chain.tiny_vmc.json", TINY_LIMITS["vmc"])
    put(here / "limits" / "tiny_dag.tiny_gfmc.json", TINY_LIMITS["gfmc"])
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench["workloads"] = [
        {"name": "tiny_chain.tiny_vmc", "config": "tiny_chain", "traffic": "tiny_vmc",
         "chips": 1, "why": "test"},
        {"name": "tiny_dag.tiny_gfmc", "config": "tiny_dag", "traffic": "tiny_gfmc",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for m in bench["end_to_end"]:
        if m["name"] == "vmc_step_s":
            m["workloads"] = ["tiny_chain.tiny_vmc"]
        elif m["name"] == "gfmc_iter_ms":
            m["workloads"] = ["tiny_dag.tiny_gfmc"]
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny_chain.tiny_vmc" if m["moves"] == "vmc_step_s"
                          else "tiny_dag.tiny_gfmc"]
    put(tmp_path / "BENCHMARK.json", bench)
    return str(tmp_path), str(here)


def tiny_run(tmp_path, workload, plant=None, trace=0):
    root, here = tiny_root(tmp_path)
    return run.run_cell(workload, 11, 0.01, trace, plant=plant, device="cpu", root=root,
                        here=here)


def test_contract_names_files_and_bounds():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    for w in bench["workloads"]:
        _, wl, cfg, tr, lim = run.cell(w["name"])
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "drivers", f"{tr['driver']}.py")) and lim
        for m in run.cell_metrics(bench, w["name"], "per_layer"):
            spec = run.load_json(HERE, "metrics", f"{m['name']}.json")
            assert os.path.exists(os.path.join(HERE, "readers", f"{spec['reader']}.py"))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_added_json_file_is_found_without_code(tmp_path):
    root, here = tiny_root(tmp_path)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "stage_ms.vmc.update", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "Trainer",
                               "moves": "vmc_step_s", "workloads": ["tiny_chain.tiny_vmc"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    json.dump({"reader": "profile", "fn": "range_ms", "args": {"range": "vmc.update"}},
              open(os.path.join(here, "metrics", "stage_ms.vmc.update.json"), "w"))
    out = run.run_cell("tiny_chain.tiny_vmc", 11, 0.01, 1, device="cpu", root=root, here=here)
    assert out["correct"], out["checks"]
    assert {"stage_ms.vmc.sample", "stage_ms.vmc.eloc", "stage_ms.vmc.grad",
            "stage_ms.vmc.update", "mfu_pct.vmc"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and list(out)[-1] == "checks"


def test_frozen_roofline_bounds():
    # PERF.md's table of kernels: r5g64 bf16 on one GFMC trial block, dp 96 chain
    r5 = roofline.bound_s(16_130_048 * roofline.row_flop(64, 20, 2, 4), 0)
    d96 = roofline.bound_s(2_625_536 * roofline.row_flop(96, 20, 1), 0)
    assert round(r5 * 1e3, 3) == 87.006 and round(d96 * 1e3, 3) == 15.821


@pytest.mark.parametrize("max_preds", [1, 2])
def test_reference_agrees_with_the_port_plain_path(max_preds):
    from pynqs_tpu_torch.bench import rand_dets
    from pynqs_tpu_torch.energy.eloc import local_energy_simple
    from pynqs_tpu_torch.ops.hamiltonian import comb_hij
    from pynqs_tpu_torch.utils.flagship import flagship_model
    from pynqs_tpu_torch.utils.system import System

    sorb, noa, nob = 12, 3, 2
    h1e, h2e = ref.stand_in_integrals(5, sorb)
    system = System.from_integrals(h1e, h2e, sorb, noa, nob)
    ham = ref.Hamiltonian(h1e, h2e, sorb, noa, nob, "cpu")
    bits = torch.as_tensor(rand_dets(np.random.default_rng(0), 6, sorb, noa, nob))
    tabs = system.tables("cpu", torch.float64)
    comb, hij = comb_hij(bits, *tabs.astuple(), tabs.hpair_best, table=system.excitation,
                         with_comb=True)
    conn = ref.connected(bits, sorb, noa, nob)
    assert conn.shape[1] == system.excitation.n_sd == ref.n_excitations(sorb, noa, nob)
    assert all({r.numpy().tobytes() for r in conn[i]} == {r.numpy().tobytes()
                                                          for r in comb[i, 1:]}
               for i in range(6))
    h_ref = ham.between(bits.repeat_interleave(comb.shape[1], 0), comb.reshape(-1, sorb))
    assert torch.allclose(h_ref.view(6, -1), hij, atol=1e-12)
    use_tensor = max_preds > 1
    model = flagship_model(system, 6, use_tensor=use_tensor, max_preds=max_preds,
                           dtype=torch.float64, device="cpu")
    P = ref.seeded_params(3, {k: tuple(p.shape) for k, p in model.named_parameters()})
    model.load_numpy_params(P)
    preds = ref.graph_preds(ham, max_preds)
    assert [list(p) for p in model.preds] == preds
    Pt = {k: torch.as_tensor(v) for k, v in P.items()}
    rows = conn.reshape(-1, sorb)
    lp = ref.log_psi(Pt, preds, rows, noa, nob, use_tensor=use_tensor)
    d = lp.double() - model.log_psi(rows)
    d[:, 1] = torch.remainder(d[:, 1] + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) < 1e-5
    el = local_energy_simple(model.log_psi, bits, tabs.astuple(), system.excitation,
                             hpair=tabs.hpair_best)
    comb_ref = torch.cat([bits[:, None].to(torch.int8), conn], 1)
    lp_ref = ref.log_psi(Pt, preds, comb_ref.reshape(-1, sorb), noa, nob, use_tensor=use_tensor)
    e_loc = ref.green_row_from(ham, bits, comb_ref, lp_ref.detach())[0]
    assert float((el[:, 0] - e_loc).abs().max()) < 1e-5


@pytest.mark.parametrize("workload", ["tiny_chain.tiny_vmc", "tiny_dag.tiny_gfmc"])
def test_sound_tiny_run_is_correct(tmp_path, workload):
    out = tiny_run(tmp_path, workload)
    assert out["correct"], out["checks"]
    assert out["metrics"]["setup_s"]["value"] > 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload,fault,number", [
    ("tiny_chain.tiny_vmc", "unchanged", None), ("tiny_chain.tiny_vmc", "half", None),
    ("tiny_chain.tiny_vmc", "half_sample", None), ("tiny_chain.tiny_vmc", "altered", None),
    ("tiny_chain.tiny_vmc", "selection", "selection_faults"),
    ("tiny_chain.tiny_vmc", "tail_in_det", "selection_faults"),
    ("tiny_dag.tiny_gfmc", "unchanged", None), ("tiny_dag.tiny_gfmc", "half", None),
    ("tiny_dag.tiny_gfmc", "altered", None), ("tiny_dag.tiny_gfmc", "rows", "logpsi_over")])
def test_planted_fault_is_not_correct(tmp_path, workload, fault, number):
    """Each fault fails the run; a fault that only one number can see
    (a wrong REDUCE split, which the reference's local energies would
    reproduce, or kernel #1 wrong on a sixteenth of the rows) fails it."""
    out = tiny_run(tmp_path, workload, plant=fault)
    assert not out["correct"], out["checks"]
    if number:
        c = out["checks"][number]
        assert c["value"] > c["limit"], out["checks"]


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse(open(os.path.join(HERE, "reference.py")).read())
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"pynqs_tpu_torch", "pynqs_tpu", "jax", "jaxlib", "flax"}
    code = ("import sys; sys.path.insert(0, %r); import bench_h100.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout
    assert not {"pynqs_tpu_torch", "pynqs_tpu", "jax"} & set(ast.literal_eval(mods))


def test_refuses_without_program_or_card(tmp_path):
    shutil.copytree(HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                        "chain_d96.vmc_step", "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and "{" not in p.stdout
    if not torch.cuda.is_available():
        p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                            "chain_d96.vmc_step", "--seed", "3", "--seconds", "1"],
                           cwd=ROOT, capture_output=True, text=True)
        assert p.returncode != 0 and "{" not in p.stdout


@pytest.mark.parametrize("workload", ["tiny_chain.tiny_vmc", "tiny_dag.tiny_gfmc"])
def test_control_fails_tiny(tmp_path, workload):
    """The lower-precision control (the reference with fp8 products, and
    TF32 in the gradient, in the program's place) comes out not correct."""
    out = tiny_run(tmp_path, workload, plant="control")
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["chain_d96.vmc_step", "r5g64.gfmc_2048"])
def test_control_fails_on_the_card(workload):
    """The same at the cell's own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.run_cell(workload, 2 ** 31 + 5, 1.0, 0, plant="control")
    assert not out["correct"], out["checks"]
