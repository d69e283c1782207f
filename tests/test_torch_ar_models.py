"""Port parity of the AR contract of the other ansätze and of the sampler's
one-site mode: each AR model's ``ar_step`` conditionals along a teacher
path against the JAX model's (the decoder's KV cache included), the
normalization of every AR model over the FCI space, and the rows that
one-site (and nested-carry two-site) sampling draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynqs_tpu import models as jm
from pynqs_tpu.sampler import ar as jar
from pynqs_tpu.utils import fci

from pynqs_tpu_torch import models as tm
from pynqs_tpu_torch.ops import lut, onv
from pynqs_tpu_torch.sampler import ar
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp
from pynqs_tpu_torch.utils.tree import tree_named_parameters, unflatten_tree

SORB, NOA, NOB = 8, 2, 2
SPACE = fci.fci_bits(SORB, NOA, NOB)  # 36 determinants
CPU = dict(device="cpu")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and under the test
    runner's parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(case, seed=0):
    g = torch.Generator().manual_seed(seed)
    kind, _, opt = case.partition(":")
    kw = dict(device="cpu", generator=g)
    if kind == "arrbm":
        return tm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5, **kw)
    if kind == "arrbm2":
        return tm.ARRBM2(SORB, NOA, NOB, nh=6, phase_hidden=5, **kw)
    if kind == "rnn":
        return tm.RNNWavefunction(SORB, NOA, NOB, hidden=6, phase_hidden=5, **kw)
    if kind == "decoder":
        return tm.DecoderWavefunction(SORB, NOA, NOB, n_layer=2, n_head=2, d_model=8,
                                      phase_hidden=5, norm_method=opt or "softmax-log", **kw)
    if kind == "mpsdec":
        return tm.MPSDecoder(SORB, NOA, NOB, dcut=3, n_layer=1, n_head=2, d_model=8,
                             pmode=opt or "element", **kw)
    if kind == "hybrid":
        return tm.HybridWavefunction(_model("arrbm", seed), tm.RBM(SORB, alpha=1, **kw))
    raise ValueError(case)


def _jax_model(case):
    kind, _, opt = case.partition(":")
    if kind == "arrbm":
        return jm.ARRBM(SORB, NOA, NOB, nh=6, phase_hidden=5)
    if kind == "arrbm2":
        return jm.ARRBM2(SORB, NOA, NOB, nh=6, phase_hidden=5)
    if kind == "rnn":
        return jm.RNNWavefunction(SORB, NOA, NOB, hidden=6, phase_hidden=5)
    if kind == "decoder":
        return jm.DecoderWavefunction(SORB, NOA, NOB, n_layer=2, n_head=2, d_model=8,
                                      phase_hidden=5, norm_method=opt)
    return jm.MPSDecoder(SORB, NOA, NOB, dcut=3, n_layer=1, n_head=2, d_model=8, pmode=opt)


def _teacher(model, bits):
    """(value of each step, mask of each step) along the rows ``bits``."""
    nps, _, n_steps, order = ar._layout(model)
    bits = bits.long()
    used_a = torch.zeros(bits.shape[0], dtype=torch.long)
    used_b = torch.zeros_like(used_a)
    vals, masks = [], []
    for k in range(n_steps):
        masks.append(ar._step_mask(model, k, used_a, used_b))
        if nps == 2:
            v = bits[:, 2 * order[k]] + 2 * bits[:, 2 * order[k] + 1]
        else:
            v = bits[:, k]
        vals.append(v)
        _, used_a, used_b = ar._place(model, k, bits.clone(), used_a, used_b, v)
    return vals, masks


@torch.no_grad()
def _walk(model, bits):
    """Each step's conditionals [n_steps, C, ncat] along the rows."""
    vals, _ = _teacher(model, bits)
    carry = model.ar_init(bits.shape[0])
    prev = torch.zeros(bits.shape[0], dtype=torch.long)
    out = []
    for k, v in enumerate(vals):
        logp, carry = model.ar_step(carry, k, prev)
        out.append(logp)
        prev = v
    return torch.stack(out)


@pytest.mark.parametrize("case", ["arrbm", "arrbm2", "rnn", "decoder:norm", "mpsdec:conv"])
def test_ar_step_walk_matches_jax(case):
    """The conditionals of every step along the 36 sector rows equal the
    JAX model's ``ar_step`` (its carry, the decoder's preallocated KV
    cache, threaded the same way) to 1e-10; masked and summed they give
    2·log|ψ| of ``log_psi``."""
    model = _model(case, seed=3)
    rng = np.random.default_rng(3)
    tree = unflatten_tree({k: p.detach().numpy() + 0.2 * rng.standard_normal(tuple(p.shape))
                           for k, p in tree_named_parameters(model).items()})
    model.load_numpy_params(tree)
    jmodel = _jax_model(case)
    bits = torch.as_tensor(SPACE)
    vals, masks = _teacher(model, bits)
    jvals = jnp.asarray(torch.stack(vals).numpy().astype(np.int32))

    def jwalk(p, vs):
        carry = jmodel.ar_init(p, vs.shape[1])
        prev = jnp.zeros(vs.shape[1], jnp.int32)
        out = []
        for k in range(vs.shape[0]):
            logp, carry = jmodel.ar_step(p, carry, k, prev)
            out.append(logp)
            prev = vs[k]
        return jnp.stack(out)

    args = (jax.tree.map(jnp.asarray, tree), jvals)
    want = np.asarray(jax.jit(jwalk).lower(*args).compile(FAST_COMPILE)(*args))
    got = _walk(model, bits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    summed = sum(apply_mask_logp(got[k], masks[k]).gather(-1, v[:, None])[:, 0]
                 for k, v in enumerate(vals))
    np.testing.assert_allclose(summed.numpy(), 2 * model.log_psi(bits)[:, 0].detach().numpy(),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("case", ["arrbm", "arrbm2", "rnn", "decoder:softmax-log",
                                  "decoder:norm", "decoder:norm-abs", "decoder:softmax-sign",
                                  "mpsdec:element", "mpsdec:linear", "mpsdec:conv",
                                  "mpsdec:spm", "hybrid"])
def test_ar_models_are_normalized(case):
    """Σ|ψ|² over the FCI space is 1 to 1e-10."""
    model = _model(case)
    la = model.log_psi(torch.as_tensor(SPACE))[:, 0].detach()
    assert abs(torch.exp(2 * la).sum().item() - 1.0) < 1e-10


def _keys(bits):
    return onv.pack_bits(bits)[:, 0]


def _check_rows(bits, counts, dropped, n):
    live = counts > 0
    rows = bits[live]
    assert (rows[:, 0::2].sum(-1) == NOA).all() and (rows[:, 1::2].sum(-1) == NOB).all()
    assert torch.unique(_keys(rows)).numel() == rows.shape[0]
    assert int(counts.sum()) == n - int(dropped)
    return rows


@pytest.mark.parametrize("case", ["arrbm", "rnn", "hybrid", "decoder:softmax-log",
                                  "mpsdec:element"])
def test_sampling_draws_unique_sector_rows(case):
    """The plain tree, DFS (nested carries dealt into groups), slabs and the
    Gumbel beam, in one-site mode (ARRBM, RNN, Hybrid) and two-site mode:
    rows unique and in the sector, Σcounts = n − dropped; the plain
    tree's counts follow |ψ|² (χ² over the 36 rows below its 0.999
    quantile, 67.99 at 35 degrees of freedom)."""
    model = _model(case, seed=1)
    gen = torch.Generator().manual_seed(2)
    n = 200_000
    bits, counts, dropped = ar.ar_sampling(model, n, capacity=64, generator=gen)
    assert int(dropped) == 0
    rows = _check_rows(bits, counts, dropped, n)
    p = torch.exp(2 * model.log_psi(rows)[:, 0].detach())
    assert rows.shape[0] == 36 and abs(p.sum().item() - 1) < 1e-10
    chi2 = ((counts[counts > 0].double() - n * p) ** 2 / (n * p)).sum().item()
    assert chi2 < 67.99, chi2
    nps = model.sites_per_step
    b, c, d = ar.ar_sampling_dfs(model, n, capacity=24, n_group=2,
                                 split_depth=4 // nps, generator=gen)
    assert _check_rows(b, c, d, n).shape[0] == 36
    b, c, d = ar.ar_sampling_slabbed(model, n, capacity=16, n_slab=3, generator=gen)
    _check_rows(b, c, d, n)
    b, logq, G, alive = ar.ar_sampling_gumbel(model, 10, gen)
    assert int(alive.sum()) == 10
    assert torch.unique(_keys(b[alive])).numel() == 10
    np.testing.assert_allclose(logq[alive].numpy(),
                               2 * model.log_psi(b[alive])[:, 0].detach().numpy(),
                               atol=1e-12, rtol=0)


def test_one_site_split_depth_and_exclusion():
    """One site per step: the static DFS split depth is the JAX package's
    (bit length of the root capacity, not halved), the tuned depth is
    exact at the rows it deals, and the final-step exclusion keeps every
    drawn row out of the excluded set."""
    model = _model("rnn", seed=4)
    assert ar._default_split(64, 1, SORB) == 6 and ar._default_split(64, 2, SORB // 2) == 3
    d, live, kept = ar.tune_dfs_split_depth(model, torch.Generator().manual_seed(5), 10_000,
                                            capacity=64, n_group=2, return_profile=True)
    assert 1 <= d <= SORB - 1 and kept[d - 1] == 10_000 and live.shape == (SORB - 1,)
    excl = SPACE[np.random.default_rng(6).permutation(36)[:12]]
    keys = lut.sort_onv(onv.pack_bits(torch.as_tensor(excl)))[0]
    bits, counts, dropped = ar.ar_sampling(model, 50_000, capacity=64,
                                           generator=torch.Generator().manual_seed(7),
                                           exclude_sorted_keys=keys)
    rows = _check_rows(bits, counts, dropped, 50_000)
    assert not lut.lut_search(keys, onv.pack_bits(rows))[1].any()
    assert rows.shape[0] == 24


def test_ar_sampler_takes_any_model():
    """``ARSampler`` (exact weights) and the JAX one-site mask agree: the
    weights are |ψ|² over the drawn rows; the mask of each one-site step is
    the JAX package's ``mask_one_site``."""
    model = _model("arrbm", seed=8)
    bits, w, diag = ARSampler(SORB, NOA, NOB, n_sample=100_000, capacity=64,
                              exact_weights=True).sample(model, torch.Generator().manual_seed(9))
    live = w > 0
    p = torch.exp(2 * model.log_psi(bits[live])[:, 0].detach())
    np.testing.assert_allclose(w[live].numpy(), (p / p.sum()).numpy(), atol=1e-14, rtol=0)
    assert float(diag["dropped_frac"]) == 0.0 and int(diag["n_unique"]) == 36
    used = torch.as_tensor([0, 1, 2])
    for k in range(SORB):
        want = jar.mask_one_site(jnp.asarray(used.numpy()), (NOA, NOB)[k % 2],
                                 SORB // 2 - k // 2 - 1)
        got = ar._step_mask(model, k, used, used)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
