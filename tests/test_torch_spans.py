"""The port's tracing on the CPU: the ``torch.profiler`` ranges of the VMC
step (DFS sampler, REDUCE local energy through the fused forward, the
chunked gradient) and of a GFMC run, each the expected number of times a
step or iteration and nested in its stage; the same results with and
without a profiler; the fused forward's row counters, below and above
its dedup threshold; and the benchmark's readers of ranges and counters
(``bench_h100/readers/spans``, ``counters``) on hand-built events."""

import pytest
import torch

from bench_h100.readers import counters
from bench_h100.readers import profile as prof_reader
from bench_h100.readers import spans
from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import fused_rnn
from pynqs_tpu_torch.optim.schedule import exponential_decay
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.system import System

CPU = torch.device("cpu")
# samples kept a step, and the chunks that split them
KEPT, ELOC_BATCH, GRAD_BATCH = 40, 16, 16
STEPS, ITERS, BRANCH = 2, 4, 2


def _vmc():
    system = System.hubbard_1d(6, 3, 3, u=4.0)
    model = GraphMPSRNN(12, 3, 3, dcut=4, phase_mode="arg", norm_mode="mpsrnn", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sampler = ARSampler(12, 3, 3, n_sample=5000, capacity=64, dfs_n_group=2, dfs_split_depth=2,
                        dfs_capacity_root=64, max_unique=KEPT)
    cfg = VMCConfig(optimizer="adamw", lr=exponential_decay(1e-2, 100, 0.1), clip_grad=0.1,
                    eloc_method="reduce", eloc_k_det=8, eloc_n_stoch=4, eloc_batch=ELOC_BATCH,
                    grad_batch=GRAD_BATCH, fused_forward=True, fused_matmul_dtype="f32")
    return VMC(model, system, sampler, cfg)


def _run_vmc(vmc):
    gen = torch.Generator().manual_seed(3)
    outs, moments = [], None
    for _ in range(STEPS):
        outs.append({k: v for k, v in vmc.step(gen, vmc.cfg.clip_grad).items() if k != "lr"})
        if moments is None:  # the first gradient, as AdamW's first moment holds it
            moments = [vmc.opt.state[p]["exp_avg"].clone() for p in vmc.model.parameters()]
    return outs, moments, [p.detach().clone() for p in vmc.model.parameters()]


def _gfmc():
    system = System.hubbard_1d(4, 2, 2, u=4.0)
    model = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn", device="cpu",
                        generator=torch.Generator().manual_seed(1))
    trial = (lambda b: fused_rnn.graph_mpsrnn_logpsi_fused(model, b,
                                                           matmul_dtype=torch.float32))
    walkers = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0], [1, 1, 0, 0, 1, 1, 0, 0],
                            [0, 1, 1, 0, 1, 0, 0, 1]], dtype=torch.int8).repeat(4, 1)
    g = GFMC(trial, system, GFMCConfig(n_walkers=12, n_iter=ITERS, branch_interval=BRANCH),
             device="cpu")
    return g, walkers


def _run_gfmc(g, walkers):
    return g.run(walkers, generator=torch.Generator().manual_seed(5))


def _traced(fn):
    """``fn()`` under the benchmark's profiler (the ranges alone on the
    host): (its result, the trace's events)."""
    with prof_reader.traced(CPU) as prof:
        out = fn()
    return out, prof_reader.events_of(prof)


def _ranges(events):
    return sorted((e[2], e[2] + e[3], e[1]) for e in events if e[0] == "cpu_range")


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


@pytest.mark.parametrize("path", ["vmc", "gfmc"])
def test_spans_nest_in_their_stages(path):
    if path == "vmc":
        vmc = _vmc()
        _, events = _traced(lambda: _run_vmc(vmc))
        n_e, n_g = -(-KEPT // ELOC_BATCH), -(-KEPT // GRAD_BATCH)
        stages = {"vmc.sample": STEPS, "vmc.eloc": STEPS, "vmc.grad": STEPS,
                  "vmc.update": STEPS}
        inner = {"ar.root": ("vmc.sample", STEPS), "ar.groups": ("vmc.sample", STEPS),
                 "ar.compact": ("vmc.sample", STEPS),
                 "hamiltonian.comb_hij": ("vmc.eloc", STEPS * n_e),
                 "eloc.select": ("vmc.eloc", STEPS * n_e),
                 "fused_rnn.forward": ("vmc.eloc", STEPS * n_e),
                 "fused_rnn.count_distinct": ("vmc.eloc", STEPS * n_e),
                 "grad.forward": ("vmc.grad", STEPS * n_g),
                 "grad.backward": ("vmc.grad", STEPS * n_g)}
    else:
        g, walkers = _gfmc()
        _, events = _traced(lambda: _run_gfmc(g, walkers))
        # the statistics read once (sync_interval covers the run), then the walkers and weights
        stages = {"gfmc.green_row": ITERS, "gfmc.transition": ITERS,
                  "gfmc.branch": ITERS // BRANCH, "gfmc.readback": 2}
        inner = {"hamiltonian.comb_hij": ("gfmc.green_row", ITERS),
                 "fused_rnn.forward": ("gfmc.green_row", ITERS),
                 "fused_rnn.count_distinct": ("gfmc.green_row", ITERS)}
    rs = _ranges(events)
    names = [r[2] for r in rs]
    for name, n in list(stages.items()) + [(k, v[1]) for k, v in inner.items()]:
        assert names.count(name) == n, name
    # the stages are the outermost ranges: no span encloses one, each span sits in its stage
    assert {r[2] for r in prof_reader._outermost(rs)} == set(stages)
    for name, (stage, _) in inner.items():
        outer = [r for r in rs if r[2] == stage]
        assert all(any(_inside(r, o) for o in outer) for r in rs if r[2] == name), name
    # the count runs after the forward's range, not inside it
    fwd = [r for r in rs if r[2] == "fused_rnn.forward"]
    cnt = [r for r in rs if r[2] == "fused_rnn.count_distinct"]
    assert all(c[0] >= f[1] for f, c in zip(fwd, cnt))


def test_a_profiler_changes_no_result():
    plain = _run_vmc(_vmc()), _run_gfmc(*_gfmc())
    traced, _ = _traced(lambda: (_run_vmc(_vmc()), _run_gfmc(*_gfmc())))
    (outs, moments, params), run = plain
    (outs_t, moments_t, params_t), run_t = traced
    for a, b in zip(outs, outs_t):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)  # energy, gnorm, ... bit for bit
    assert all(torch.equal(a, b) for a, b in zip(moments, moments_t))
    assert all(torch.equal(a, b) for a, b in zip(params, params_t))
    for k in ("e_gen", "e_gen_b", "wbar", "walkers", "weights"):
        assert (run[k] == run_t[k]).all(), k


def test_fused_forward_counts_rows_only_under_a_profiler(monkeypatch):
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu", generator=torch.Generator().manual_seed(0))
    rows = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0], [1, 1, 0, 0, 1, 1, 0, 0],
                         [0, 1, 1, 0, 1, 0, 0, 1], [1, 0, 0, 1, 0, 1, 1, 0]], dtype=torch.int8)
    # 4 distinct rows, planted 3, 1, 4 and 2 times in a mixed order
    flat = rows[torch.tensor([0, 2, 0, 3, 2, 1, 2, 3, 0, 2])]
    monkeypatch.setattr(fused_rnn, "PACK_ROWS", 3)  # the packing in several blocks
    tallies = (fused_rnn.ROWS, fused_rnn.DISTINCT, fused_rnn.EVALUATED)
    for c in tallies:
        monkeypatch.setattr(c, "n", 0)
    fused_rnn.graph_mpsrnn_logpsi_fused(model, flat, matmul_dtype=torch.float32)
    assert fused_rnn.ROWS.n == 0 and fused_rnn.DISTINCT.n == 0 and fused_rnn.EVALUATED.n == 0

    def three_calls():
        _traced(lambda: [fused_rnn.graph_mpsrnn_logpsi_fused(model, b, matmul_dtype=torch.float32)
                         for b in (flat, flat[:2], flat[:0])])
        return [int(c.n) for c in tallies]

    # below the threshold the forward runs on every row
    assert three_calls() == [12, 4 + 2, 12]
    # with the dedup on the 10 rows: it ran on their 4 distinct rows, and adds its own count
    for c in tallies:
        monkeypatch.setattr(c, "n", 0)
    monkeypatch.setattr(fused_rnn, "DEDUP_MIN_ROWS", 3)
    assert three_calls() == [12, 4 + 2, 4 + 2]
    # rows wider than two 32-bit words have no int64 key: the packed rows sorted as they are
    g = torch.Generator().manual_seed(2)
    wide = (torch.rand(9, 70, generator=g) < 0.5).to(torch.int8)
    wide = wide[torch.randint(9, (50,), generator=g)]
    assert int(fused_rnn.count_distinct(wide)) == torch.unique(wide, dim=0).shape[0]


def test_span_readers_on_hand_built_events(monkeypatch):
    ev = [("cpu_range", "vmc.sample", 0.0, 10.0), ("cpu_range", "vmc.sample", 20.0, 10.0),
          ("cpu_range", "vmc.grad", 10.0, 10.0), ("gpu_range", "vmc.sample", 1.0, 40.0),
          ("cpu_op", "cudaLaunchKernel", 1.0, 1.0), ("cpu_op", "cudaMemcpyAsync", 9.5, 1.0),
          ("cpu_op", "cudaLaunchKernel", 10.0, 1.0), ("cpu_op", "cuLaunchKernel", 21.0, 1.0),
          ("cpu_op", "cudaMemsetAsync", 29.0, 1.0), ("cpu_op", "cudaLaunchKernelExC", 25.0, 1.0),
          ("cpu_op", "cudaStreamSynchronize", 3.0, 1.0), ("kernel", "cudaLaunchKernel", 2.0, 1.0),
          ("cpu_op", "cudaLaunchKernel", 35.0, 1.0)]
    work = {"steps": 2}
    assert spans.launches(ev, work, range="vmc.sample") == 5 / 2
    assert spans.launches(ev, work, range="vmc.grad") == 1 / 2
    assert spans.launches(ev, work, range="vmc.eloc") is None
    monkeypatch.setattr(fused_rnn.ROWS, "n", 0)
    monkeypatch.setattr(fused_rnn.DISTINCT, "n", 0)
    assert spans.distinct_pct(ev, work) is None
    monkeypatch.setattr(fused_rnn.ROWS, "n", 400)
    monkeypatch.setattr(fused_rnn.DISTINCT, "n", torch.tensor(48))
    assert spans.distinct_pct(ev, work) == pytest.approx(12.0)
    with monkeypatch.context() as m:  # a program without the counters
        m.delattr(fused_rnn, "DISTINCT")
        assert spans.distinct_pct(ev, work) is None
    # the share of the rows kernel #1 ran on
    monkeypatch.setattr(fused_rnn.ROWS, "n", 0)
    monkeypatch.setattr(fused_rnn.EVALUATED, "n", 0)
    assert counters.evaluated_pct(ev, work) is None
    monkeypatch.setattr(fused_rnn.ROWS, "n", 400)
    monkeypatch.setattr(fused_rnn.EVALUATED, "n", 52)
    assert counters.evaluated_pct(ev, work) == pytest.approx(13.0)
    with monkeypatch.context() as m:
        m.delattr(fused_rnn, "EVALUATED")
        assert counters.evaluated_pct(ev, work) is None
