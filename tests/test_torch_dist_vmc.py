"""Data parallelism on the CPU: the port over two gloo ranks against the
port in one process (f64).

One module-scoped spawn of two ranks runs every scenario
(``torch_dist_ranks.vmc_scenarios``): an ``ExactSampler`` VMC of 5 steps
with REDUCE (the tail's uniforms drawn for both ranks and sliced), an
MCMC VMC (the chains and every draw split the same way) and a CG-SR run
of 3 steps each, and a fixed-node GFMC run.  The same scenarios in one
process give the reference: the histories and the parameters after
every step agree to 1e-10 (the ranks sum in another order), the
parameters are equal on both ranks after every step (max |Δ| = 0), and
the shared generator stays in sync.
"""

import numpy as np
import pytest

from pynqs_tpu_torch.parallel import run_ranks

from torch_dist_ranks import vmc_scenarios

TOL = 1e-10


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = run_ranks(vmc_scenarios, 2, backend="gloo", device="cpu", timeout=240,
                      rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), num_threads=1)
    return ranks, vmc_scenarios(None)


@pytest.mark.parametrize("kind", ["exact", "mcmc", "cg"])
def test_vmc_over_two_ranks_equals_one_process(runs, kind):
    ranks, single = runs
    ref = single[kind]
    for r in ranks:
        got = r[kind]
        np.testing.assert_allclose(got["history"], ref["history"], atol=TOL, rtol=0)
        for step, (p, q) in enumerate(zip(got["params"], ref["params"])):
            for k in q:
                np.testing.assert_allclose(p[k], q[k], atol=TOL, rtol=0,
                                           err_msg=f"{kind} step {step} {k}")


def test_parameters_replicated_and_generator_in_sync(runs):
    ranks, _ = runs
    for r in ranks:
        for kind in ("exact", "mcmc", "cg"):
            assert r[kind]["spread"] == [0.0] * len(r[kind]["history"]), kind
            assert all(r[kind]["sync"]), kind
        assert r["gfmc"]["sync"]


def test_gfmc_over_two_ranks_equals_one_process(runs):
    ranks, single = runs
    ref = single["gfmc"]
    for r in ranks:
        got = r["gfmc"]
        for k in ("e_gen", "e_gen_b", "wbar", "weights"):
            np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=TOL, err_msg=k)
        np.testing.assert_array_equal(got["walkers"], ref["walkers"])
