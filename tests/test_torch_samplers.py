"""Port parity: the sampler and local-energy variants — RESTRICTED, the
``exclude_sorted_keys`` final-step mask, slabs, the Gumbel beam, MCMC,
and the dedup'd / sample-space / bound local energies — against the JAX
package (deterministic pieces, to 1e-12 or exactly) or against |ψ|² on
an enumerable system (stochastic samplers, by their law).

The law checks use fixed seeds on the 36 determinants of 4 sites at
2α/2β: counts are held by χ² with 35 degrees of freedom below 85
(P ≈ 1e-5 under the law), estimators by |z| < 5 per determinant.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.energy import eloc as jeloc
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops import lut as jlut
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.sampler.ar import gumbel_importance_weights as jgumbel_w
from pynqs_tpu.sampler.restricted import RestrictedSampler as JRestricted
from pynqs_tpu.utils import System as JSystem
from pynqs_tpu.utils import fci

from pynqs_tpu_torch.energy import eloc
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import lut, onv
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler import ar
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.sampler.mcmc import MCMCSampler, exchange_proposal
from pynqs_tpu_torch.sampler.restricted import RestrictedSampler
from pynqs_tpu_torch.utils.system import System

SPACE = fci.fci_bits(8, 2, 2)  # 36 determinants
CHI2_MAX = 85.0  # 35 degrees of freedom


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and under the test
    runner's parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **kw):
    jm = JModel(8, 2, 2, dcut=3, phase_mode="arg", norm_mode="mpsrnn", **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GraphMPSRNN(8, 2, 2, dcut=3, phase_mode="arg", norm_mode="mpsrnn", device="cpu", **kw)
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


def _probs(tm):
    with torch.no_grad():
        la = tm.log_psi(torch.as_tensor(SPACE))[:, 0]
    p = torch.exp(2 * (la - la.max()))
    return (p / p.sum()).numpy()


def _index(bits):
    """Each row's place in SPACE."""
    key = {r.tobytes(): i for i, r in enumerate(SPACE)}
    return np.array([key[r.tobytes()] for r in np.asarray(bits, np.int8)])


def _chi2(counts, p):
    n = counts.sum()
    return float(((counts - n * p) ** 2 / (n * p)).sum())


def _jax_keys(rows):
    return jlut.sort_onv(jonv.pack_bits(jnp.asarray(rows)))[0]


# ---------------- deterministic pieces against JAX ----------------


def test_restricted_sampler_matches_jax():
    """The sector filter, the exclusion and the |ψ|² weights."""
    jm, params, tm = _pair()
    rng = np.random.default_rng(0)
    states = np.concatenate([SPACE[rng.permutation(36)[:14]],
                             rng.integers(0, 2, (6, 8)).astype(np.int8)])
    keys = _jax_keys(SPACE[[3, 7, 30]])
    js = JRestricted(8, 2, 2, states=states, exclude_sorted_keys=keys)
    ts = RestrictedSampler(8, 2, 2, states=states, exclude_sorted_keys=np.asarray(keys))
    np.testing.assert_array_equal(ts.states, js.states)
    jb, jw, _, _ = js.sample(jm, params, jax.random.PRNGKey(0))
    tb, tw, diag = ts.sample(tm)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-12)
    assert float(diag["dropped_frac"]) == -1.0 and int(diag["n_unique"]) == ts.n_states
    with pytest.raises(ValueError, match="no states left"):
        RestrictedSampler(8, 2, 2, states=np.ones((3, 8), np.int8))


def test_exclude_mask_matches_jax_and_sampling_avoids_the_set():
    """The final-step mask against the JAX package's expression; no
    sampled row falls in the excluded set, a prefix without an allowed
    completion being dropped (the JAX package would send its count to
    value 0: into the set or out of the sector)."""
    _, _, tm = _pair()
    rng = np.random.default_rng(1)
    excl = SPACE[rng.permutation(36)[:9]]
    jkeys = _jax_keys(excl)
    tkeys = torch.as_tensor(np.asarray(jkeys)).long()
    bits = SPACE[rng.integers(0, 36, 40)].copy()
    s = 2
    bits[:, 2 * s:2 * s + 2] = 0
    cand = []
    for v in range(4):
        b2 = jnp.asarray(bits).at[:, 2 * s].set(v & 1).at[:, 2 * s + 1].set((v >> 1) & 1)
        cand.append(~jlut.lut_search(jkeys, jonv.pack_bits(b2))[1])
    np.testing.assert_array_equal(ar._exclude_mask(torch.as_tensor(bits), s, tkeys).numpy(),
                                  np.asarray(jnp.stack(cand, -1)))
    b, c, dropped = ar.ar_sampling(tm, 5000, capacity=36, generator=torch.Generator().manual_seed(2),
                                   exclude_sorted_keys=tkeys)
    live = c > 0
    assert int(c.sum()) + int(dropped) == 5000 and int(c.sum()) > 0
    assert not lut.lut_search(tkeys, onv.pack_bits(b[live]))[1].any()
    assert (b[live][:, 0::2].sum(1) == 2).all() and (b[live][:, 1::2].sum(1) == 2).all()


def test_gumbel_importance_weights_match_jax():
    rng = np.random.default_rng(2)
    for dt in (np.float64, np.float32):
        logq = np.log(rng.dirichlet(np.ones(24))).astype(dt)
        logq[[2, 9]] = -1e30
        G = (logq + rng.gumbel(size=24)).astype(dt)
        alive = logq > -1e29
        jw, jk = jgumbel_w(jnp.asarray(logq), jnp.asarray(G), jnp.asarray(alive))
        tw, tk = ar.gumbel_importance_weights(torch.as_tensor(logq), torch.as_tensor(G),
                                              torch.as_tensor(alive))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12 if dt is np.float64
                                   else 1e-6, atol=0)
        assert np.isfinite(tw.numpy()).all()


def test_mcmc_proposal_matches_a_numpy_restatement():
    """``exchange_proposal`` against pynqs_tpu/sampler/mcmc.py:54-81 in
    numpy on the same draws (the channel, the occupied and the virtual
    slot)."""
    rng = np.random.default_rng(3)
    for noa, nob in ((3, 2), (0, 2), (4, 4)):
        norb = 6
        bits = np.zeros((50, 2 * norb), np.int8)
        for r in range(50):
            bits[r, 2 * rng.permutation(norb)[:noa]] = 1
            bits[r, 2 * rng.permutation(norb)[:nob] + 1] = 1
        u = rng.random((50, 3))
        nva, nvb = norb - noa, norb - nob
        can_a, can_b = noa > 0 and nva > 0, nob > 0 and nvb > 0
        ch = (u[:, 0] >= 0.5).astype(int) if can_a and can_b else np.full(50, 0 if can_a else 1)
        no_c = np.where(ch == 0, noa, nob)
        nv_c = np.where(ch == 0, nva, nvb)
        io = (u[:, 1] * no_c).astype(int)
        iv = (u[:, 2] * nv_c).astype(int)
        want = bits.copy()
        for r in range(50):
            c = ch[r]
            occ = [2 * i + c for i in range(norb) if bits[r, 2 * i + c]]
            vir = [2 * i + c for i in range(norb) if not bits[r, 2 * i + c]]
            want[r, occ[io[r]]] ^= 1
            want[r, vir[iv[r]]] ^= 1
        got = exchange_proposal(torch.as_tensor(bits), torch.as_tensor(u), noa, nob)
        np.testing.assert_array_equal(got.numpy(), want)


def test_local_energy_variants_match_jax():
    """The dedup'd SIMPLE energy, the sample-space energy and the bound
    ``make_local_energy`` against the JAX package (1e-12); REDUCE with
    k_det = n_sd through ``make_local_energy`` equals SIMPLE."""
    jm, params, tm = _pair(4)
    jsys, tsys = JSystem.hubbard_1d(4, 2, 2, u=4.0), System.hubbard_1d(4, 2, 2, u=4.0)
    jops = tuple(jnp.asarray(np.asarray(x)) for x in jsys.tables.astuple())
    tt = tsys.tables("cpu", torch.float64)
    tops, table = tt.astuple(), tsys.excitation
    bits = SPACE[::3]
    n_max = bits.shape[0] * (1 + table.n_sd)

    @jax.jit
    def jall(p, b):
        fn = partial(jm.log_psi, p)
        dd, nu = jeloc.local_energy_simple_dedup(fn, b, jops, jsys.excitation, n_unique_max=n_max,
                                                 hpair=jsys.tables.hpair_best)
        sel = jnp.arange(0, b.shape[0], 2)
        lp = fn(b[sel])
        ss = jeloc.local_energy_sample_space(b[sel], lp, jlut.WavefunctionLUT.build(b[sel], lp),
                                             jops, jsys.excitation, batch=3,
                                             hpair=jsys.tables.hpair_best)
        mk = jeloc.make_local_energy(jm, jsys.excitation, jops)(p, b)
        return dd, nu, ss, mk

    jd, jn, jss, jmk = jall(params, jnp.asarray(bits))
    fwd = lambda b: tm.log_psi(b).detach()  # noqa: E731
    tb = torch.as_tensor(bits)
    td, tn = eloc.local_energy_simple_dedup(fwd, tb, tops, table, n_unique_max=n_max,
                                            hpair=tt.hpair_best)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
    assert tn == int(jn)
    sel = tb[::2]
    lp = fwd(sel)
    tss = eloc.local_energy_sample_space(sel, lp, lut.WavefunctionLUT.build(sel, lp), tops, table,
                                         batch=3, hpair=tt.hpair_best)
    np.testing.assert_allclose(tss.numpy(), np.asarray(jss), rtol=0, atol=1e-12)
    simple = eloc.make_local_energy(tm, table, tops)(tb)
    np.testing.assert_allclose(simple.numpy(), np.asarray(jmk), rtol=0, atol=1e-12)
    red = eloc.make_local_energy(tm, table, tops, method="reduce")(
        tb, torch.Generator().manual_seed(0), k_det=table.n_sd, n_stoch=4)
    np.testing.assert_allclose(red.numpy(), simple.numpy(), rtol=0, atol=1e-12)
    with pytest.raises(OverflowError):
        eloc.local_energy_simple_dedup(fwd, tb, tops, table, n_unique_max=5)
    with pytest.raises(NotImplementedError):
        eloc.make_local_energy(tm, table, tops, method="sample_space")


# ---------------- stochastic samplers, by their law ----------------


def test_slabbed_sampling():
    """One slab equals ``ar_sampling`` for the same generator; four slabs'
    merged counts follow |ψ|², rows unique, nothing dropped."""
    _, _, tm = _pair(5)
    a = ar.ar_sampling(tm, 3000, capacity=36, generator=torch.Generator().manual_seed(6))
    b = ar.ar_sampling_slabbed(tm, 3000, capacity=36, n_slab=1,
                               generator=torch.Generator().manual_seed(6))

    def table_of(bits, counts):
        live = counts > 0
        return dict(zip(map(bytes, bits[live].numpy()), counts[live].tolist()))

    assert table_of(a[0], a[1]) == table_of(b[0], b[1]) and int(b[2]) == int(a[2])
    bits, counts, dropped = ar.ar_sampling_slabbed(tm, 40_000, capacity=36, n_slab=4,
                                                   generator=torch.Generator().manual_seed(7))
    live = counts > 0
    assert bits.shape[0] == 4 * 36 and int(dropped) == 0 and int(counts.sum()) == 40_000
    assert eloc.unique_rows(bits[live])[0].shape[0] == int(live.sum())
    full = np.zeros(36)
    full[_index(bits[live].numpy())] = counts[live].numpy()
    assert _chi2(full, _probs(tm)) < CHI2_MAX
    # through the sampler: unique rows, weights the normalized counts
    sb, sw, diag = ARSampler(8, 2, 2, n_sample=20_000, capacity=12, n_slab=3).sample(
        tm, torch.Generator().manual_seed(8))
    assert abs(float(sw.sum()) - 1) < 1e-12 and int(diag["n_unique"]) == int((sw > 0).sum())
    assert eloc.unique_rows(sb[sw > 0])[0].shape[0] == int((sw > 0).sum())


def test_gumbel_beam_is_an_unbiased_sample_without_replacement():
    """Every draw's leaves are distinct; Σ_i w_i 1[x_i = x] averaged over
    draws estimates |ψ(x)|² (|z| < 5 for each determinant)."""
    _, _, tm = _pair(9)
    p = _probs(tm)
    g = torch.Generator().manual_seed(10)
    R, C = 400, 6
    est = np.zeros((R, 36))
    for r in range(R):
        bits, logq, G, alive = ar.ar_sampling_gumbel(tm, C, g)
        w, keep = ar.gumbel_importance_weights(logq, G, alive)
        assert int(alive.sum()) == C and eloc.unique_rows(bits)[0].shape[0] == C
        np.add.at(est[r], _index(bits[keep].numpy()), w[keep].numpy())
    mean, se = est.mean(0), est.std(0, ddof=1) / np.sqrt(R)
    z = np.abs(mean - p) / np.maximum(se, 1e-12)
    assert (z[p > 1e-6] < 5).all(), z
    np.testing.assert_allclose(logq[alive].exp().numpy(), p[_index(bits[alive].numpy())],
                               rtol=1e-10)


def test_mcmc_chains_keep_the_sector_and_follow_the_law():
    """4000 independent chains from random determinants after 60 steps:
    the sector is kept and the final states follow |ψ|² (χ²)."""
    _, _, tm = _pair(11)
    s = MCMCSampler(8, 2, 2, n_chain=4000, n_sweep=60)
    g = torch.Generator().manual_seed(12)
    st = s.init_state(tm, g)
    assert (st[:, 0::2].sum(1) == 2).all() and (st[:, 1::2].sum(1) == 2).all()
    bits, w, diag, st2 = s.sample(tm, g, st)
    assert torch.equal(bits, st2) and abs(float(w.sum()) - 1) < 1e-12
    assert (bits[:, 0::2].sum(1) == 2).all() and (bits[:, 1::2].sum(1) == 2).all()
    assert 0.0 < float(diag["acc_rate"]) <= 1.0 and float(diag["dropped_frac"]) == -1.0
    counts = np.bincount(_index(bits.numpy()), minlength=36)
    assert _chi2(counts, _probs(tm)) < CHI2_MAX


def test_vmc_threads_the_mcmc_chains_and_thermalizes_once(monkeypatch):
    _, _, tm = _pair(13)
    calls = []
    run = MCMCSampler.run

    def counted(self, model, generator, bits, n_steps):
        calls.append(n_steps)
        return run(self, model, generator, bits, n_steps)

    monkeypatch.setattr(MCMCSampler, "run", counted)
    s = MCMCSampler(8, 2, 2, n_chain=64, n_sweep=3, therm=7)
    v = VMC(tm, System.hubbard_1d(4, 2, 2), s, VMCConfig(lr=0.01))
    hist = v.run(torch.Generator().manual_seed(14), n_iter=3)
    assert calls == [7, 3, 3, 3] and len(hist) == 3 and np.isfinite(hist).all()
    assert v.chain_state.shape == (64, 8)
    before = v.chain_state.clone()
    v.step(torch.Generator().manual_seed(15), 1.0)
    assert calls[-1] == 3 and not torch.equal(before, v.chain_state)
